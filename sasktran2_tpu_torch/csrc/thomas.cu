// Block-tridiagonal Thomas solve for the N-stream BVP, one launch.
//
// Replaces the Pallas TPU kernels _fwd_kernel and _bwd_kernel of
// thomas_solve_pallas (sasktran2_tpu/ops/pallas_thomas.py:47-190).
//
// Solves lo[p] x[p-1] + di[p] x[p] + up[p] x[p+1] = r[p] for p = 0..P-1
// (lo[0] and up[P-1] ignored) with lo/di/up [P, K, K, W] and r [P, K, W],
// row-major, wavelength W the fastest axis, K <= 24. Forward elimination
// per layer:
//   denom = di[p] - lo[p] c[p-1],  rhs = r[p] - lo[p] y[p-1],
//   denom [c[p] | y[p]] = [up[p] | rhs]  (Gauss-Jordan, no pivoting),
// then back substitution x[p] = y[p] - c[p] x[p+1]. x is the result; the
// buffers c and y (sized [P, K, K, W] and [P, K, W]) hold c[p] and y[p]
// in a lane-major layout, c[p][w] a contiguous K x K block, for the back
// substitution.
//
// Design. A block holds LW wavelength lanes (8 in f32, 4 in f64), one
// warp per lane. Within a warp, thread t works on row i = t / TPR of its
// lane's system and on one TPR-th of its columns, TPR = 32 / KMAX threads
// per row (KMAX = 8, 16 or 32 is the template bound on K; rows and columns
// past K are identity padding). So the K rows of a lane sit in one warp:
// each Gauss-Jordan pivot row travels to the other rows through a
// per-warp shared buffer fenced by __syncwarp, and each row's factor
// through __shfl_sync, with no block barrier. The pivot row is published
// as it stands and normalized by its readers, so the reciprocal of the
// pivot is taken while the row is in flight.
// The blocks of layer p + 2 are copied into a triple-buffered shared tile
// with cp.async while layer p eliminates; the only block barrier is one
// per layer, which hands a finished copy to every warp. The tile is laid
// out [row][column][lane] with a row stride of K LW + 1, which spreads a
// warp's reads of one column over the banks; the global side of the copy
// walks W fastest, so the copies coalesce, and each thread walks its
// share of the rows with carries instead of divisions. Where W is a
// multiple of 16 bytes' worth of elements (the slice's W = 1024) each
// copy moves 16 bytes, four lanes at once; otherwise one element. The carry
// (c[p-1] | y[p-1]) of each lane and the pivot rows stay in shared memory,
// 16-byte aligned, and are read as 16-byte vectors. c[p] and y[p] go to device memory
// lane-major, so that each warp writes and, in the back substitution,
// reads one contiguous block; the back substitution keeps the next four
// layers' loads in flight while it finishes layer p and sums each row
// across its TPR threads with __shfl_xor_sync.
//
// What bounds it: the layer recursion is serial, and at the slice's
// W = 1024 there are only 1024 independent systems, about 8 warps per
// SM. Each layer is KMAX dependent pivot steps (shared store, warp
// fence, shared load, FMA) per warp; the card's memory rate would allow
// the 328 MB of operands in about 0.1 ms.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// Copy E consecutive elements (4, 8 or 16 bytes) global -> shared, or
// zero-fill them where `valid` is false.
template <typename T, int E>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem, bool valid) {
  constexpr int BYTES = static_cast<int>(sizeof(T)) * E;
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(src_bytes));
  } else if constexpr (BYTES == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(src_bytes));
  } else {
    static_assert(BYTES == 4, "copies are 4, 8 or 16 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Load N consecutive values from 16-byte-aligned shared memory, as
// 16-byte vectors where N allows.
template <typename T, int N>
__device__ __forceinline__ void lds_vec(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4 && N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(src)[q];
      dst[4 * q] = v.x;
      dst[4 * q + 1] = v.y;
      dst[4 * q + 2] = v.z;
      dst[4 * q + 3] = v.w;
    }
  } else if constexpr (sizeof(T) == 8 && N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const double2 v = reinterpret_cast<const double2*>(src)[q];
      dst[2 * q] = v.x;
      dst[2 * q + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) dst[q] = src[q];
  }
}

template <typename T, int N>
__device__ __forceinline__ void sts_vec(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4 && N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      reinterpret_cast<float4*>(dst)[q] =
          make_float4(src[4 * q], src[4 * q + 1], src[4 * q + 2], src[4 * q + 3]);
    }
  } else if constexpr (sizeof(T) == 8 && N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      reinterpret_cast<double2*>(dst)[q] = make_double2(src[2 * q], src[2 * q + 1]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) dst[q] = src[q];
  }
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// Shared-memory layout, in elements of T. Tiles hold [row i][col k][lane]
// with a row stride of K * LW + E (E = elements per copy), so a warp's
// reads of one column spread over the banks and every copy lands
// aligned; every other region starts 16-byte aligned.
struct Layout {
  int rs;        // tile row stride: K * LW + E
  int tile_m;    // one matrix tile: K * rs
  int tile;      // one layer: lo, di, up tiles + r ([row][lane])
  int carry;     // carries, LW x [KMAX][KMAX + 4]: c[p-1] | y[p-1]
  int piv;       // pivot rows, LW x [2][2 KMAX + 4]
  int xs;        // x[p+1] of the back substitution, LW x [2][KMAX]
  int total;
};

__host__ __device__ inline Layout layout(int K, int KMAX, int LW, int E) {
  Layout L;
  L.rs = K * LW + E;
  L.tile_m = K * L.rs;
  L.tile = round4(3 * L.tile_m + K * LW);
  L.carry = 3 * L.tile;
  L.piv = L.carry + LW * KMAX * (KMAX + 4);
  L.xs = L.piv + LW * 2 * (2 * KMAX + 4);
  L.total = L.xs + LW * 2 * KMAX;
  return L;
}

// Which parts of a layer's tiles this thread copies: lanes lw .. lw + E
// of the tile rows (m, i, k) = rr, rr + step, ... of the 3 K^2 rows,
// walked with a carry instead of divisions.
struct CopyPlan {
  int lw, m0, i0, k0, dm, di, dk;
  bool r_row;  // this thread also copies r[i_r], lanes lw .. lw + E
  int i_r;
};

template <int LW, int E>
__device__ inline CopyPlan copy_plan(int K) {
  constexpr int per_row = LW / E;        // copies per tile row
  constexpr int step = 32 * LW / per_row;  // rows per pass of the block
  CopyPlan cp;
  cp.lw = (threadIdx.x % per_row) * E;
  const int rr = threadIdx.x / per_row;
  cp.k0 = rr % K;
  cp.i0 = (rr / K) % K;
  cp.m0 = rr / (K * K);
  cp.dk = step % K;
  cp.di = (step / K) % K;
  cp.dm = step / (K * K);
  cp.r_row = rr < K;
  cp.i_r = rr;
  return cp;
}

// Issue the copies of layer p's lo, di, up and r for this block's lanes
// into tile buffer `buf`; lanes past W are zero-filled.
template <typename T, int LW, int E>
__device__ __forceinline__ void load_layer(const T* lo, const T* di, const T* up, const T* r,
                                           T* buf, const Layout& L, const CopyPlan& cp,
                                           int p, int K, int W, int w0) {
  const long long mat = static_cast<long long>(K) * K * W;
  const int wl = w0 + cp.lw;
  const bool live = wl < W;
  int m = cp.m0, i = cp.i0, k = cp.k0;
  while (m < 3) {
    const T* base = m == 0 ? lo : (m == 1 ? di : up);
    const T* src = base + p * mat + static_cast<long long>(i * K + k) * W + wl;
    cp_async<T, E>(buf + m * L.tile_m + i * L.rs + k * LW + cp.lw, live ? src : di, live);
    k += cp.dk;
    i += cp.di;
    m += cp.dm;
    if (k >= K) {
      k -= K;
      ++i;
    }
    if (i >= K) {
      i -= K;
      ++m;
    }
  }
  if (cp.r_row) {
    const T* src = r + (static_cast<long long>(p) * K + cp.i_r) * W + wl;
    cp_async<T, E>(buf + 3 * L.tile_m + cp.i_r * LW + cp.lw, live ? src : r, live);
  }
}

template <typename T, int KMAX, int LW, int E>
__global__ void __launch_bounds__(32 * LW)
thomas_kernel(const T* __restrict__ lo, const T* __restrict__ di,
              const T* __restrict__ up, const T* __restrict__ r,
              T* __restrict__ c, T* __restrict__ y, T* __restrict__ x,
              int P, int K, int W) {
  constexpr int TPR = 32 / KMAX;   // threads per row
  constexpr int CPT = KMAX / TPR;  // columns per thread
  constexpr int CS = KMAX + 4;     // carry row stride
  constexpr int PS = 2 * KMAX + 4; // pivot row stride
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const Layout L = layout(K, KMAX, LW, E);
  const CopyPlan plan = copy_plan<LW, E>(K);

  const int lw = threadIdx.x / 32;  // this warp's lane of the block
  const int t = threadIdx.x % 32;
  const int i = t / TPR;            // this thread's row
  const int h = t % TPR;            // this thread's column part
  const int j0 = h * CPT;
  const int w0 = blockIdx.x * LW;
  const int w = w0 + lw;
  const bool live = w < W;
  const bool real_row = i < K;

  T* carry = smem + L.carry + lw * KMAX * CS;  // [KMAX][CS]: c[p-1] | y[p-1]
  T* pbuf = smem + L.piv + lw * 2 * PS;        // [2][PS]: pivot row | rhs
  T* xs = smem + L.xs + lw * 2 * KMAX;         // [2][KMAX]

  load_layer<T, LW, E>(lo, di, up, r, smem, L, plan, 0, K, W, w0);
  cp_async_commit();
  if (P > 1) load_layer<T, LW, E>(lo, di, up, r, smem + L.tile, L, plan, 1, K, W, w0);
  cp_async_commit();

  T ra[CPT];  // row i of denom, columns j0 .. j0 + CPT
  T rb[CPT];  // row i of up, then of c[p]
  T ry;       // row i of rhs, then of y[p]; the same in every part of the row

  for (int p = 0; p < P; ++p) {
    cp_async_wait_1();
    __syncthreads();
    if (p + 2 < P) {
      load_layer<T, LW, E>(lo, di, up, r, smem + ((p + 2) % 3) * L.tile, L, plan, p + 2, K,
                        W, w0);
    }
    cp_async_commit();
    const T* buf = smem + (p % 3) * L.tile;
    const T* t_lo = buf + i * L.rs + lw;  // column k at t_lo[k * LW]
    const T* t_di = t_lo + L.tile_m;
    const T* t_up = t_di + L.tile_m;

    // --- row i of [denom | up | rhs], identity past K -----------------------
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int j = j0 + cc;
      ra[cc] = (real_row && j < K) ? t_di[j * LW] : (i == j ? T(1) : T(0));
      rb[cc] = (real_row && j < K) ? t_up[j * LW] : T(0);
    }
    ry = real_row ? buf[3 * L.tile_m + i * LW + lw] : T(0);
    if (p > 0 && real_row) {
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k < K) {
          const T l = t_lo[k * LW];
          const T* ck = carry + k * CS;
          T cv[CPT];
          lds_vec<T, CPT>(cv, ck + j0);
#pragma unroll
          for (int cc = 0; cc < CPT; ++cc) ra[cc] -= l * cv[cc];
          ry -= l * ck[KMAX];
        }
      }
    }

    // --- Gauss-Jordan over the KMAX rows, pivots through the warp ------------
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      const int hs = s / CPT;  // the part holding column s
      const int cs = s % CPT;
      T* pb = pbuf + (s & 1) * PS;
      // row s publishes itself as it stands; the reciprocal of its pivot
      // is taken meanwhile, off the store -> fence -> load path
      if (i == s) {
        sts_vec<T, CPT>(pb + j0, ra);
        sts_vec<T, CPT>(pb + KMAX + j0, rb);
        if (h == 0) pb[2 * KMAX] = ry;
      }
      const T piv = __shfl_sync(FULL, ra[cs], s * TPR + hs);
      const T f = __shfl_sync(FULL, ra[cs], i * TPR + hs);
      const T inv = T(1) / piv;
      __syncwarp();
      // the normalized pivot row (rounded as the plain twin's
      // lane_gauss_solve rounds it) replaces row s and is subtracted from
      // the others
      T pa[CPT], pr[CPT];
      lds_vec<T, CPT>(pa, pb + j0);
      lds_vec<T, CPT>(pr, pb + KMAX + j0);
      const T py = pb[2 * KMAX] * inv;
      const bool pivot_row = i == s;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const T na = pa[cc] * inv;
        const T nb = pr[cc] * inv;
        ra[cc] = pivot_row ? na : ra[cc] - f * na;
        rb[cc] = pivot_row ? nb : rb[cc] - f * nb;
      }
      ry = pivot_row ? py : ry - f * py;
    }

    // --- c[p], y[p] to device memory (lane-major) and to the carry ------------
    if (live && real_row) {
      T* c_p = c + ((static_cast<long long>(p) * W + w) * K + i) * K;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        if (j0 + cc < K) c_p[j0 + cc] = rb[cc];
      }
      if (h == 0) y[(static_cast<long long>(p) * W + w) * K + i] = ry;
    }
    sts_vec<T, CPT>(carry + i * CS + j0, rb);
    if (h == 0) carry[i * CS + KMAX] = ry;
    __syncwarp();
  }

  // --- back substitution, layer P-1 down to 0 ---------------------------------
  // Every thread reads back only what it wrote itself in the forward pass.
  if (!live) return;
  constexpr int DEPTH = 4;  // layers of c and y in flight
  T cq[DEPTH][CPT];
  T yq[DEPTH];
  auto fetch = [&](int p, T* cn, T& yn) {
    const T* c_p = c + ((static_cast<long long>(p) * W + w) * K + i) * K;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      cn[cc] = (p >= 0 && real_row && j0 + cc < K) ? c_p[j0 + cc] : T(0);
    }
    yn = (p >= 0 && real_row && h == 0)
             ? y[(static_cast<long long>(p) * W + w) * K + i] : T(0);
  };
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) fetch(P - 1 - d, cq[d], yq[d]);
  for (int p = P - 1, q = 0; p >= 0; --p, ++q) {
    T cur[CPT];
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) cur[cc] = cq[0][cc];
    T acc = yq[0];
#pragma unroll
    for (int d = 0; d + 1 < DEPTH; ++d) {
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) cq[d][cc] = cq[d + 1][cc];
      yq[d] = yq[d + 1];
    }
    fetch(p - DEPTH, cq[DEPTH - 1], yq[DEPTH - 1]);
    if (p < P - 1) {
      T xn[CPT];
      lds_vec<T, CPT>(xn, xs + ((q - 1) & 1) * KMAX + j0);
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) acc -= cur[cc] * xn[cc];
    }
#pragma unroll
    for (int o = 1; o < TPR; o <<= 1) acc += __shfl_xor_sync(FULL, acc, o);
    if (h == 0) {
      xs[(q & 1) * KMAX + i] = acc;
      if (real_row) x[(static_cast<long long>(p) * K + i) * W + w] = acc;
    }
    __syncwarp();
  }
}

template <typename T, int KMAX, int LW, int E>
int launch_k(const void* lo, const void* di, const void* up, const void* r, void* c,
             void* y, void* x, int P, int K, int W, cudaStream_t stream) {
  const Layout L = layout(K, KMAX, LW, E);
  const size_t shared = static_cast<size_t>(L.total) * sizeof(T);
  auto kernel = thomas_kernel<T, KMAX, LW, E>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (W + LW - 1) / LW;
  kernel<<<blocks, 32 * LW, shared, stream>>>(
      static_cast<const T*>(lo), static_cast<const T*>(di), static_cast<const T*>(up),
      static_cast<const T*>(r), static_cast<T*>(c), static_cast<T*>(y), static_cast<T*>(x),
      P, K, W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int LW, int E>
int launch_e(const void* lo, const void* di, const void* up, const void* r, void* c,
             void* y, void* x, int P, int K, int W, cudaStream_t s) {
  if (K <= 8) return launch_k<T, 8, LW, E>(lo, di, up, r, c, y, x, P, K, W, s);
  if (K <= 16) return launch_k<T, 16, LW, E>(lo, di, up, r, c, y, x, P, K, W, s);
  return launch_k<T, 32, LW, E>(lo, di, up, r, c, y, x, P, K, W, s);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// 16-byte copies where every tile row starts 16-byte aligned (W a multiple
// of the elements per copy), element copies otherwise.
template <typename T, int LW>
int launch(const void* lo, const void* di, const void* up, const void* r, void* c,
           void* y, void* x, int P, int K, int W, void* stream) {
  if (P < 1 || K < 1 || K > 24 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  if (W % V == 0 && aligned16(lo) && aligned16(di) && aligned16(up) && aligned16(r)) {
    return launch_e<T, LW, V>(lo, di, up, r, c, y, x, P, K, W, s);
  }
  return launch_e<T, LW, 1>(lo, di, up, r, c, y, x, P, K, W, s);
}

}  // namespace

extern "C" int thomas_solve_f32(const void* lo, const void* di, const void* up,
                                const void* r, void* c, void* y, void* x,
                                int P, int K, int W, void* stream) {
  return launch<float, 8>(lo, di, up, r, c, y, x, P, K, W, stream);
}

extern "C" int thomas_solve_f64(const void* lo, const void* di, const void* up,
                                const void* r, void* c, void* y, void* x,
                                int P, int K, int W, void* stream) {
  return launch<double, 4>(lo, di, up, r, c, y, x, P, K, W, stream);
}
