// Tournament-Jacobi symmetric eigensolve of many small matrices.
//
// Replaces the Pallas TPU kernel built by _make_kernel and launched by
// jacobi_eigh_pallas (sasktran2_tpu/ops/pallas_jacobi.py:54-155).
//
// Input a [P, n, n, W] symmetric in its two matrix axes, n even and
// 2 <= n <= 32, wavelength W the fastest axis. Output the unsorted
// eigenvalues w [P, n, W] (the diagonal after the last sweep) and the
// eigenvectors v [P, n, n, W] (columns). Each sweep runs n-1 rounds of
// the circle-method tournament (sasktran2_tpu/ops/eigen.py:33-50); a
// round takes the n/2 disjoint pairs (p, q) and computes every pair's
// rotation from the matrix as the round found it, in the Pallas kernel's
// half-angle tangent form (pallas_jacobi.py:72-88): with x = a_qq - a_pp,
// y = 2 a_pq, r = |(x, y)|,
//   t = y / (r + x) for x >= 0,  c = 1 / sqrt(1 + t^2),  s = t c;
//   u = 1 / t = y / (r - x) for x < 0,  c = |u| / sqrt(1 + u^2),
//   s = sign(u) / sqrt(1 + u^2);  and no rotation where a_pq == 0,
// which is the angle 0.5 atan2(y, x) of the reference's scan, up to
// rounding. For x < 0 the Pallas kernel forms t = (r - x) / y itself:
// where |y| is below about 1e-19 |x| (a converged pair whose order is
// reversed, met in the polarized thermal-infrared solves), t^2 overflows
// float32 and its c = s = 0 zeroes two eigenvectors; u cannot overflow. Then A <- J^T A J (columns, then rows, as lanes.py:362-391
// orders them) and V <- V J.
//
// Two designs, chosen by n.
//
// n <= 8: one thread per (layer, lane), P*W threads (102,400 at the
// 16-stream slice, n = 8); W is the fastest axis, so neighbouring threads
// load and store neighbouring addresses. A is kept as its upper triangle
// only, n(n+1)/2 values: each new entry a'_ij (i <= j) is formed directly
// from the four old entries a_ij, a_i,pj, a_pi,j, a_pi,pj (pk = partner of
// k this round) by the column step and then the row step, so the result
// is symmetric by construction and the per-sweep re-symmetrization of the
// reference is the identity here. The order is a template constant and
// the sweep's rounds and pairs are unrolled completely: the tournament is
// a compile-time table, every index is a constant, and A (36 values) and
// V (64) live in registers. What bounds it: the FP32 instruction rate.
// At n = 8 a round is about 340 FMA/MUL instructions a thread for A and V
// plus 4 rotations (one sqrt, one divide, one rsqrt each); 7 sweeps x 7
// rounds over 102,400 matrices is about 2e9 instructions, against 55.7 MB
// of traffic.
//
// 8 < n <= 32 (the polarized 16-stream solver's n = 24, the 8-stream
// one's n = 12): one group of G threads per matrix (G = 8 for n <= 16,
// 16 above; G divides 32, so groups never straddle a warp), one thread
// per rotation pair, and A and V as full n x n arrays in shared memory,
// with the row stride and the per-matrix stride that
// ops/jacobi_cuda.launch_shape chooses. A block takes THREADS / G
// consecutive lanes of one layer, so the global loads and stores of each
// (i, j) entry are contiguous along W. The round table (the (p, q) of
// every pair of every round, from ops/eigen.stacked_round_tables) comes
// from the host and is copied into shared memory. In round r thread k
// owns the pair (p_k, q_k): it computes that pair's rotation and writes
// it to its matrix's slot; after a __syncwarp it forms the new rows p_k
// and q_k of A one 2 x 2 block (p_k, q_k) x (p_m, q_m) at a time, in
// place, since each new block depends on the old block and the two
// rotations only (columns, then rows, as the reference orders them);
// then it rotates columns p_k and q_k of V. A thread touches only its own
// pair's rows of A and columns of V in a round, so one __syncwarp at its
// end orders it against the next. A is a full matrix, as in the
// reference, and is re-symmetrized after every sweep. Nothing is indexed
// in a local array, so ptxas reports no stack frame.
//
// What bounds it: shared-memory instructions. At n = 24 a round moves
// about 4 n^2 four-byte words per matrix (each of A's and V's entries read
// and written once) through shared memory: 102,400 matrices x 7 sweeps x
// 23 rounds is about 0.15 TB, some 4.6 ms at 33 TB/s (132 SMs x 128 B a
// clock at 1.98 GHz), against 0.862 ms of FP32 work. A warp holds two
// such matrices, 12 of each group's 16 lanes busy, and executes about 210
// shared-memory instructions a round (one pass each: the layout below
// has no bank conflict in f32), so the card's one pass a clock per SM
// puts its floor near 6.6 ms. Each slot carries its pair's column
// offsets, and the block and V updates load two blocks (four rows)
// before storing any, which keeps the integer work and the exposed
// latency down.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }
__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }
__device__ __forceinline__ float copysign_t(float x, float y) { return copysignf(x, y); }
__device__ __forceinline__ double copysign_t(double x, double y) { return copysign(x, y); }

template <typename T>
__device__ __forceinline__ void rotation(T app, T aqq, T apq, T& c, T& s) {
  const T x = aqq - app;
  const T y = T(2) * apq;
  const T r = sqrt_t(x * x + y * y);
  if (apq == T(0)) {
    c = T(1);
    s = T(0);
  } else if (x >= T(0)) {
    const T d = r + x;
    const T t = y / (d == T(0) ? T(1) : d);
    c = rsqrt_t(T(1) + t * t);
    s = t * c;
  } else {
    // r - x >= 2 |x| > 0; the rotation is near a swap when |u| is small
    const T u = y / (r - x);
    const T h = rsqrt_t(T(1) + u * u);
    c = abs_t(u) * h;
    s = copysign_t(h, u);
  }
}

// ---------------------------------------------------------------- n <= 8

// Player at seat k of round r of the circle method: seat 0 holds player 0,
// the other seats hold players 1..n-1 rotated right by r.
__host__ __device__ constexpr int player(int k, int r, int n) {
  return k == 0 ? 0 : 1 + (((k - 1 - r) % (n - 1)) + (n - 1)) % (n - 1);
}

// Index of (i, j), i <= j, in the packed upper triangle of order n.
__host__ __device__ constexpr int tri(int i, int j, int n) {
  return i * n - (i * (i - 1)) / 2 + (j - i);
}

__host__ __device__ constexpr int sym(int i, int j, int n) {
  return i <= j ? tri(i, j, n) : tri(j, i, n);
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
jacobi_kernel(const T* __restrict__ a_in, T* __restrict__ w_out,
              T* __restrict__ v_out, int P, int W, int sweeps) {
  constexpr int n = N;
  constexpr int TRI = N * (N + 1) / 2;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(P) * W) return;
  const long long p = t / W;
  const int w = static_cast<int>(t - p * W);
  const long long mat = static_cast<long long>(n) * n * W;

  T a[TRI];
  T v[N * N];
  T cf[N];  // this round's cosine of the pair holding each index
  T kf[N];  // -s for the pair's p, +s for its q
  int pm[N];  // partner of each index this round

  const T* a_p = a_in + p * mat + w;
#pragma unroll
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int j = 0; j < n; ++j) {
      v[i * N + j] = (i == j) ? T(1) : T(0);
      if (j >= i) {
        a[tri(i, j, n)] = T(0.5) * (a_p[(i * n + j) * W] + a_p[(j * n + i) * W]);
      }
    }
  }

#pragma unroll 1
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll
    for (int r = 0; r < n - 1; ++r) {
#pragma unroll
      for (int k = 0; k < n / 2; ++k) {
        const int i0 = player(k, r, n);
        const int i1 = player(n - 1 - k, r, n);
        const int pk = i0 < i1 ? i0 : i1;
        const int qk = i0 < i1 ? i1 : i0;
        T c, s;
        rotation(a[tri(pk, pk, n)], a[tri(qk, qk, n)], a[tri(pk, qk, n)], c, s);
        cf[pk] = c;
        cf[qk] = c;
        kf[pk] = -s;
        kf[qk] = s;
        pm[pk] = qk;
        pm[qk] = pk;
      }
      // A <- J^T A J on the upper triangle: column step, then row step
      T an[TRI];
#pragma unroll
      for (int i = 0; i < n; ++i) {
        const int pi = pm[i];
#pragma unroll
        for (int j = 0; j < n; ++j) {
          if (j >= i) {
            const int pj = pm[j];
            const T bij = a[sym(i, j, n)] * cf[j] + a[sym(i, pj, n)] * kf[j];
            const T bpj = a[sym(pi, j, n)] * cf[j] + a[sym(pi, pj, n)] * kf[j];
            an[tri(i, j, n)] = bij * cf[i] + bpj * kf[i];
          }
        }
      }
#pragma unroll
      for (int e = 0; e < TRI; ++e) a[e] = an[e];
      // V <- V J
#pragma unroll
      for (int k = 0; k < n / 2; ++k) {
        const int i0 = player(k, r, n);
        const int i1 = player(n - 1 - k, r, n);
        const int pk = i0 < i1 ? i0 : i1;
        const int qk = i0 < i1 ? i1 : i0;
        const T c = cf[pk], s = kf[qk];
#pragma unroll
        for (int i = 0; i < n; ++i) {
          const T vip = v[i * N + pk];
          const T viq = v[i * N + qk];
          v[i * N + pk] = vip * c - viq * s;
          v[i * N + qk] = viq * c + vip * s;
        }
      }
    }
  }

  T* w_p = w_out + p * static_cast<long long>(n) * W + w;
  T* v_p = v_out + p * mat + w;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    w_p[i * W] = a[tri(i, i, n)];
#pragma unroll
    for (int j = 0; j < n; ++j) v_p[(i * n + j) * W] = v[i * N + j];
  }
}

template <typename T, int N>
void launch_fixed(const void* a, void* w, void* v, int P, int W, int sweeps,
                  cudaStream_t s) {
  const long long total = static_cast<long long>(P) * W;
  const int blocks = static_cast<int>((total + THREADS - 1) / THREADS);
  jacobi_kernel<T, N><<<blocks, THREADS, 0, s>>>(
      static_cast<const T*>(a), static_cast<T*>(w), static_cast<T*>(v), P, W,
      sweeps);
}

// ------------------------------------------------------------ 8 < n <= 32

// A round's rotation of one pair, as the pair's thread leaves it for the
// other threads of its group: (c, s) and the byte offsets of the pair's
// columns p and q in a row, read with one 16-byte load in f32.
template <typename T>
struct alignas(16) Rot {
  T c, s;
  int p, q;
};

template <typename T>
__device__ __forceinline__ T& at(T* row, int byte_offset) {
  return *reinterpret_cast<T*>(reinterpret_cast<char*>(row) + byte_offset);
}

// The 2 x 2 block of A in rows r1, r2 and the columns p, q of a slot.
template <typename T>
struct Block {
  T x1p, x1q, x2p, x2q;
};

template <typename T>
__device__ __forceinline__ Block<T> load_block(T* A1, T* A2, const Rot<T>& e) {
  return Block<T>{at(A1, e.p), at(A1, e.q), at(A2, e.p), at(A2, e.q)};
}

// J^T B J: the columns by the slot's rotation, then the rows r1, r2 by
// (c, s1), in the reference's order.
template <typename T>
__device__ __forceinline__ void store_rotated(T* A1, T* A2, const Rot<T>& e,
                                              const Block<T>& x, T c, T s1) {
  const T b1p = x.x1p * e.c + x.x1q * (-e.s);
  const T b1q = x.x1q * e.c + x.x1p * e.s;
  const T b2p = x.x2p * e.c + x.x2q * (-e.s);
  const T b2q = x.x2q * e.c + x.x2p * e.s;
  at(A1, e.p) = b1p * c + b2p * (-s1);
  at(A1, e.q) = b1q * c + b2q * (-s1);
  at(A2, e.p) = b2p * c + b1p * s1;
  at(A2, e.q) = b2q * c + b1q * s1;
}

// Shared memory: the rotation slots [n/2][THREADS / G] (16 bytes each in
// f32, 32 in f64), so that the groups of a warp read theirs from distinct
// banks; then THREADS / G matrices of `mat_stride` elements each, A
// [n][rs] and V [n][rs]; then the round table ([n-1][n/2] pairs (p, q),
// p < q, as bytes).
//
// Banks: a shared-memory pass serves L = 128 / sizeof(T) elements (32
// four-byte words; a half-warp of eight-byte ones), that is GPW groups.
// In one access instruction every thread of a group reads or writes a
// distinct row of A (or column of V) at one column (row), and the odd
// row stride puts those in distinct banks. The groups of a pass are
// matched in partners, the second half of the pass with the first, whose
// matrices start in the same bank (mat_stride = 2G modulo L); the second
// partner takes its pair's rows (columns) in the order (q, p), the first
// in the order (p, q), so that together they cover the n rows once.
// With G = 8 in f32 a pass holds two such partner pairs, 16 words apart.
// So every access is one pass for n <= 32 in f32 (n <= 16 in f64).
template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
jacobi_group_kernel(const T* __restrict__ a_in, T* __restrict__ w_out,
                    T* __restrict__ v_out, int P, int n, int W, int sweeps,
                    const uchar2* __restrict__ table_in, int rs,
                    int mat_stride) {
  constexpr int MATS = THREADS / G;
  constexpr int GPW = 128 / static_cast<int>(sizeof(T)) / G;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = n / 2;
  Rot<T>* slots = reinterpret_cast<Rot<T>*>(smem);
  T* mats = reinterpret_cast<T*>(slots + h * MATS);
  uchar2* table = reinterpret_cast<uchar2*>(mats + MATS * mat_stride);

  const int tiles = (W + MATS - 1) / MATS;
  const long long p = blockIdx.x / tiles;
  const int w0 = (blockIdx.x - static_cast<int>(p) * tiles) * MATS;
  const long long mat = static_cast<long long>(n) * n * W;

  for (int e = threadIdx.x; e < (n - 1) * h; e += THREADS) table[e] = table_in[e];
  // A from its lanes (zeros past W), V = I
  const T* a_p = a_in + p * mat + w0;
  for (int e = threadIdx.x; e < n * n * MATS; e += THREADS) {
    const int l = e % MATS;
    const int ij = e / MATS;
    const int i = ij / n;
    const int j = ij - i * n;
    T* A = mats + l * mat_stride;
    A[i * rs + j] = (w0 + l < W) ? a_p[static_cast<long long>(ij) * W + l] : T(0);
    A[(n + i) * rs + j] = (i == j) ? T(1) : T(0);
  }
  __syncthreads();

  const int k = threadIdx.x % G;
  const int l = threadIdx.x / G;
  const bool swap = GPW > 1 && l % GPW >= GPW / 2;
  T* A = mats + l * mat_stride;
  T* V = A + n * rs;

#pragma unroll 1
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll 1
    for (int r = 0; r < n - 1; ++r) {
      const uchar2* tr = table + r * h;
      int pk = 0, qk = 0;
      T c = T(1), s = T(0);
      if (k < h) {
        const uchar2 pq = tr[k];
        pk = pq.x;
        qk = pq.y;
        rotation(A[pk * rs + pk], A[qk * rs + qk], A[pk * rs + qk], c, s);
        slots[k * MATS + l] = Rot<T>{c, s, pk * static_cast<int>(sizeof(T)),
                                     qk * static_cast<int>(sizeof(T))};
      }
      __syncwarp();
      if (k < h) {
        // The pair's rows (and V's columns) as this group takes them: (p,
        // q) with s, or (q, p) with -s, which is the same rotation (see
        // the layout above).
        const int r1 = swap ? qk : pk;
        const int r2 = swap ? pk : qk;
        const T s1 = swap ? -s : s;
        // rows r1, r2 of A <- J^T A J, block by block, two blocks at a
        // time: both loaded before either is stored, since the compiler
        // cannot tell that their addresses differ
        T* A1 = A + r1 * rs;
        T* A2 = A + r2 * rs;
        int m = 0;
#pragma unroll 1
        for (; m + 2 <= h; m += 2) {
          const Rot<T> e0 = slots[m * MATS + l];
          const Rot<T> e1 = slots[(m + 1) * MATS + l];
          const Block<T> x0 = load_block(A1, A2, e0);
          const Block<T> x1 = load_block(A1, A2, e1);
          store_rotated(A1, A2, e0, x0, c, s1);
          store_rotated(A1, A2, e1, x1, c, s1);
        }
        if (m < h) {
          const Rot<T> e0 = slots[m * MATS + l];
          store_rotated(A1, A2, e0, load_block(A1, A2, e0), c, s1);
        }
        // columns r1, r2 of V <- V J, four rows at a time (two at the end)
        const int o1 = r1 * static_cast<int>(sizeof(T));
        const int o2 = r2 * static_cast<int>(sizeof(T));
        int i = 0;
#pragma unroll 1
        for (; i + 4 <= n; i += 4) {
          T v1[4], v2[4];
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            v1[d] = at(V + (i + d) * rs, o1);
            v2[d] = at(V + (i + d) * rs, o2);
          }
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            at(V + (i + d) * rs, o1) = v1[d] * c + v2[d] * (-s1);
            at(V + (i + d) * rs, o2) = v2[d] * c + v1[d] * s1;
          }
        }
#pragma unroll 1
        for (; i < n; ++i) {
          const T v1 = at(V + i * rs, o1);
          const T v2 = at(V + i * rs, o2);
          at(V + i * rs, o1) = v1 * c + v2 * (-s1);
          at(V + i * rs, o2) = v2 * c + v1 * s1;
        }
      }
      __syncwarp();
    }
    // A <- (A + A^T) / 2, each pair i < j by one thread of the group
    for (int i = k; i < n; i += G) {
      for (int j = i + 1; j < n; ++j) {
        const T m = T(0.5) * (A[i * rs + j] + A[j * rs + i]);
        A[i * rs + j] = m;
        A[j * rs + i] = m;
      }
    }
    __syncwarp();
  }
  __syncthreads();

  T* w_p = w_out + p * static_cast<long long>(n) * W + w0;
  for (int e = threadIdx.x; e < n * MATS; e += THREADS) {
    const int l = e % MATS;
    const int i = e / MATS;
    if (w0 + l < W) {
      w_p[static_cast<long long>(i) * W + l] = mats[l * mat_stride + i * rs + i];
    }
  }
  T* v_p = v_out + p * mat + w0;
  for (int e = threadIdx.x; e < n * n * MATS; e += THREADS) {
    const int l = e % MATS;
    const int ij = e / MATS;
    const int i = ij / n;
    const int j = ij - i * n;
    if (w0 + l < W) {
      v_p[static_cast<long long>(ij) * W + l] = mats[l * mat_stride + (n + i) * rs + j];
    }
  }
}

template <typename T, int G>
int launch_group(const void* a, void* w, void* v, int P, int n, int W, int sweeps,
                 const void* table, int rs, int mat_stride, int smem_bytes,
                 cudaStream_t s) {
  constexpr int MATS = THREADS / G;
  const long long tiles = (W + MATS - 1) / MATS;
  if (static_cast<long long>(P) * tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = jacobi_group_kernel<T, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<int>(P * tiles), THREADS, smem_bytes, s>>>(
      static_cast<const T*>(a), static_cast<T*>(w), static_cast<T*>(v), P, n, W,
      sweeps, static_cast<const uchar2*>(table), rs, mat_stride);
  return static_cast<int>(cudaSuccess);
}

// The launch shape comes from ops/jacobi_cuda.launch_shape, which also
// sets the strides for the bank layout (checked on the CPU by
// tests/test_torch_jacobi_layout.py). This checks only what keeps the
// kernel inside its block's shared memory.
template <typename T>
bool shape_ok(int n, int group, int rs, int mat_stride, int smem_bytes) {
  const long long h = n / 2;
  const long long mats = THREADS / group;
  return (group == 8 || group == 16) && h <= group && rs >= n &&
         mat_stride >= 2 * n * rs &&
         smem_bytes >= mats * (h * static_cast<long long>(sizeof(Rot<T>)) +
                               mat_stride * static_cast<long long>(sizeof(T))) +
                           (n - 1) * h * static_cast<long long>(sizeof(uchar2));
}

template <typename T>
int launch(const void* a, void* w, void* v, int P, int n, int W, int sweeps,
           const void* table, int group, int rs, int mat_stride, int smem_bytes,
           void* stream) {
  if (P < 1 || W < 1 || n < 2 || n > 32 || (n % 2) != 0 || sweeps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 2: launch_fixed<T, 2>(a, w, v, P, W, sweeps, s); break;
    case 4: launch_fixed<T, 4>(a, w, v, P, W, sweeps, s); break;
    case 6: launch_fixed<T, 6>(a, w, v, P, W, sweeps, s); break;
    case 8: launch_fixed<T, 8>(a, w, v, P, W, sweeps, s); break;
    default: {
      if (table == nullptr || !shape_ok<T>(n, group, rs, mat_stride, smem_bytes)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      const int err = group == 8
          ? launch_group<T, 8>(a, w, v, P, n, W, sweeps, table, rs, mat_stride,
                               smem_bytes, s)
          : launch_group<T, 16>(a, w, v, P, n, W, sweeps, table, rs, mat_stride,
                                smem_bytes, s);
      if (err != 0) return err;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, w, v: the [P, n, n, W] input and the outputs. For n > 8, `table` is
// the device copy of the round table and group, row_stride, mat_stride and
// smem_bytes are the launch shape of ops/jacobi_cuda.launch_shape; for
// n <= 8 they are not read.
extern "C" int jacobi_eigh_f32(const void* a, void* w, void* v, int P, int n, int W,
                               int sweeps, const void* table, int group,
                               int row_stride, int mat_stride, int smem_bytes,
                               void* stream) {
  return launch<float>(a, w, v, P, n, W, sweeps, table, group, row_stride, mat_stride,
                       smem_bytes, stream);
}

extern "C" int jacobi_eigh_f64(const void* a, void* w, void* v, int P, int n, int W,
                               int sweeps, const void* table, int group,
                               int row_stride, int mat_stride, int smem_bytes,
                               void* stream) {
  return launch<double>(a, w, v, P, n, W, sweeps, table, group, row_stride, mat_stride,
                        smem_bytes, stream);
}
