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
//   t = y / (r + x) for x >= 0,  t = (r - x) / y for x < 0,
//   c = 1 / sqrt(1 + t^2),  s = t c,  and no rotation where a_pq == 0,
// which is the angle 0.5 atan2(y, x) of the reference's scan, up to
// rounding. Then A <- J^T A J (columns, then rows, as lanes.py:362-391
// orders them) and V <- V J.
//
// Design: one thread per (layer, lane), P*W threads (102,400 at the
// 16-stream slice, n = 8); W is the fastest axis, so neighbouring threads
// load and store neighbouring addresses. A is kept as its upper triangle
// only, n(n+1)/2 values: each new entry a'_ij (i <= j) is formed directly
// from the four old entries a_ij, a_i,pj, a_pi,j, a_pi,pj (pk = partner of
// k this round) by the column step and then the row step, so the result
// is symmetric by construction and the per-sweep re-symmetrization of the
// reference is the identity here. For n <= 8 the order is a template
// constant and the sweep's rounds and pairs are unrolled completely: the
// tournament is a compile-time table, every index is a constant, and A
// (36 values) and V (64) live in registers. For 8 < n <= 32 the rounds
// stay a loop, the indices are run-time values, and A and V sit in local
// memory (L1-cached), as in the first version of this kernel.
//
// What bounds it: FP32 issue. At n = 8 a round is about 340 FMA/MUL
// instructions a thread for A and V plus 4 rotations (one sqrt, one
// divide, one rsqrt each); 7 sweeps x 7 rounds over 102,400 matrices is
// about 2e9 instructions, against 55.7 MB of traffic.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

template <typename T>
__device__ __forceinline__ void rotation(T app, T aqq, T apq, T& c, T& s) {
  const T x = aqq - app;
  const T y = T(2) * apq;
  const T r = sqrt_t(x * x + y * y);
  T t;
  if (apq == T(0)) {
    t = T(0);
  } else if (x >= T(0)) {
    const T d = r + x;
    t = y / (d == T(0) ? T(1) : d);
  } else {
    t = (r - x) / y;
  }
  c = rsqrt_t(T(1) + t * t);
  s = t * c;
}

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

// NMAX: the order (FIXED) or the bound on the run-time order n.
template <typename T, int NMAX, bool FIXED>
__global__ void __launch_bounds__(THREADS)
jacobi_kernel(const T* __restrict__ a_in, T* __restrict__ w_out,
              T* __restrict__ v_out, int P, int n_rt, int W, int sweeps) {
  constexpr int UN = FIXED ? NMAX : 1;            // unroll over the order
  constexpr int UR = FIXED ? NMAX - 1 : 1;        // unroll over the rounds
  constexpr int UH = FIXED ? NMAX / 2 : 1;        // unroll over the pairs
  constexpr int TRI = NMAX * (NMAX + 1) / 2;
  constexpr int UT = FIXED ? TRI : 1;             // unroll over A's entries
  const int n = FIXED ? NMAX : n_rt;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(P) * W) return;
  const long long p = t / W;
  const int w = static_cast<int>(t - p * W);
  const long long mat = static_cast<long long>(n) * n * W;

  T a[TRI];
  T v[NMAX * NMAX];
  T cf[NMAX];  // this round's cosine of the pair holding each index
  T kf[NMAX];  // -s for the pair's p, +s for its q
  int pm[NMAX];  // partner of each index this round

  const T* a_p = a_in + p * mat + w;
#pragma unroll (UN)
  for (int i = 0; i < n; ++i) {
#pragma unroll (UN)
    for (int j = 0; j < n; ++j) {
      v[i * NMAX + j] = (i == j) ? T(1) : T(0);
      if (j >= i) {
        a[tri(i, j, n)] = T(0.5) * (a_p[(i * n + j) * W] + a_p[(j * n + i) * W]);
      }
    }
  }

#pragma unroll 1
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll (UR)
    for (int r = 0; r < n - 1; ++r) {
#pragma unroll (UH)
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
#pragma unroll (UN)
      for (int i = 0; i < n; ++i) {
        const int pi = pm[i];
#pragma unroll (UN)
        for (int j = 0; j < n; ++j) {
          if (j >= i) {
            const int pj = pm[j];
            const T bij = a[sym(i, j, n)] * cf[j] + a[sym(i, pj, n)] * kf[j];
            const T bpj = a[sym(pi, j, n)] * cf[j] + a[sym(pi, pj, n)] * kf[j];
            an[tri(i, j, n)] = bij * cf[i] + bpj * kf[i];
          }
        }
      }
#pragma unroll (UT)
      for (int e = 0; e < n * (n + 1) / 2; ++e) a[e] = an[e];
      // V <- V J
#pragma unroll (UH)
      for (int k = 0; k < n / 2; ++k) {
        const int i0 = player(k, r, n);
        const int i1 = player(n - 1 - k, r, n);
        const int pk = i0 < i1 ? i0 : i1;
        const int qk = i0 < i1 ? i1 : i0;
        const T c = cf[pk], s = kf[qk];
#pragma unroll (UN)
        for (int i = 0; i < n; ++i) {
          const T vip = v[i * NMAX + pk];
          const T viq = v[i * NMAX + qk];
          v[i * NMAX + pk] = vip * c - viq * s;
          v[i * NMAX + qk] = viq * c + vip * s;
        }
      }
    }
  }

  T* w_p = w_out + p * static_cast<long long>(n) * W + w;
  T* v_p = v_out + p * mat + w;
#pragma unroll (UN)
  for (int i = 0; i < n; ++i) {
    w_p[i * W] = a[tri(i, i, n)];
#pragma unroll (UN)
    for (int j = 0; j < n; ++j) v_p[(i * n + j) * W] = v[i * NMAX + j];
  }
}

template <typename T, int NMAX, bool FIXED>
void launch_n(const void* a, void* w, void* v, int P, int n, int W, int sweeps,
              cudaStream_t s) {
  const long long total = static_cast<long long>(P) * W;
  const int blocks = static_cast<int>((total + THREADS - 1) / THREADS);
  jacobi_kernel<T, NMAX, FIXED><<<blocks, THREADS, 0, s>>>(
      static_cast<const T*>(a), static_cast<T*>(w), static_cast<T*>(v), P, n, W,
      sweeps);
}

template <typename T>
int launch(const void* a, void* w, void* v, int P, int n, int W, int sweeps, void* stream) {
  if (P < 1 || W < 1 || n < 2 || n > 32 || (n % 2) != 0 || sweeps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 2: launch_n<T, 2, true>(a, w, v, P, n, W, sweeps, s); break;
    case 4: launch_n<T, 4, true>(a, w, v, P, n, W, sweeps, s); break;
    case 6: launch_n<T, 6, true>(a, w, v, P, n, W, sweeps, s); break;
    case 8: launch_n<T, 8, true>(a, w, v, P, n, W, sweeps, s); break;
    default:
      if (n <= 16) {
        launch_n<T, 16, false>(a, w, v, P, n, W, sweeps, s);
      } else {
        launch_n<T, 32, false>(a, w, v, P, n, W, sweeps, s);
      }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int jacobi_eigh_f32(const void* a, void* w, void* v, int P, int n, int W,
                               int sweeps, void* stream) {
  return launch<float>(a, w, v, P, n, W, sweeps, stream);
}

extern "C" int jacobi_eigh_f64(const void* a, void* w, void* v, int P, int n, int W,
                               int sweeps, void* stream) {
  return launch<double>(a, w, v, P, n, W, sweeps, stream);
}
