// Block-tridiagonal Thomas solve for the N-stream BVP, one launch.
//
// Replaces the Pallas TPU kernels _fwd_kernel and _bwd_kernel of
// thomas_solve_pallas (sasktran2_tpu/ops/pallas_thomas.py:47-190), and
// for 24 < K <= 48 the scan the JAX package runs there instead
// (_thomas_forward, sasktran2_tpu/ops/lanes.py:403, whose blocks are
// solved by a pivoted jnp.linalg.solve, lanes.py:113-133).
//
// Solves lo[p] x[p-1] + di[p] x[p] + up[p] x[p+1] = r[p] for p = 0..P-1
// (lo[0] and up[P-1] ignored) with lo/di/up [P, K, K, W] and r [P, K, W],
// row-major, wavelength W the fastest axis, K <= 48. Forward elimination
// per layer:
//   denom = di[p] - lo[p] c[p-1],  rhs = r[p] - lo[p] y[p-1],
//   denom [c[p] | y[p]] = [up[p] | rhs]  (Gauss-Jordan),
// then back substitution x[p] = y[p] - c[p] x[p+1]. x is the result. Two
// branches:
//
// K <= 24 (thomas_kernel, "v3"): Gauss-Jordan without pivoting, as the
// Pallas kernel. The buffers c and y (sized [P, K, K, W] and [P, K, W])
// hold c[p] and y[p] in a lane-major layout, c[p][w] a contiguous K x K
// block, for the back substitution.
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
//
// 24 < K <= 48 (thomas_pivot_kernel; the polarized 16-stream solver's
// K = 48): Gauss-Jordan with partial (row) pivoting, as the reference's
// pivoted solve. What bounds it: per lane and layer a 48 x 48 x 48
// product lo c[p-1] and the elimination of a 48 x 97 system, 68.9 GFLOP
// for [100, 48, 48, 1024] (1.03 ms at the FP32 rate; its 2.87 GB of
// operands 0.86 ms), but 1024 systems each serial over P layers and 48
// pivot steps a layer, each step a column arg-max and a pivot row that
// every thread of the lane must see. Tensor cores are no route: the
// products stay in full FP32 (no TF32). v3's warp per lane does not fit
// 48 x 97 systems, so the design is:
// - A lane's system is held in registers by TPL = RG x CG threads, thread
//   (g, h) owning rows g + RG m (m < 48 / RG) and, in each half of
//   [denom | up] and c[p-1], columns h + CG n (n < 48 / CG); h = 0 also
//   owns the rhs column. f32: RG = 16, CG = 4 (a 3 x 24 tile, 64 threads
//   a lane); f64: RG = 16, CG = 8 (3 x 12, 128 threads a lane). At
//   [100, 48, 48, 1024] f32 on the H100 (tools/probe_thomas_pivot.py):
//   8 x 8 (6 x 12 tiles, longer select chains to pick the pivot row out
//   of registers) 10.5 ms, 4 x 16 (12 x 6, spilling) 13.8 ms, this 8.95
//   ms. The elimination is about 80% of that, and its arg-max a quarter:
//   per step the arg-max, the pivot row's selection and the publishing
//   stores come to several instructions per FMA.
// - A block holds LW lanes (8 in f32, 4 in f64: 32 bytes, one sector, of
//   each W-minor operand row), 512 threads, lane the fastest thread
//   index: every global load or store of a warp covers whole sectors, so
//   the W-minor operands are read as they lie, with no transposing pass.
//   All lanes of a block take the same steps, so they share its barriers.
//   About 158 KB of shared memory: one block, 8 lanes, per SM, so the
//   1024 lanes of the slice run in a single wave.
// - A step: every warp finds the pivot of each of its lanes from the
//   published column (a shuffle arg-max over the unpivoted rows, the
//   lowest row on ties, so all warps agree); the pivot row's owners
//   publish it scaled by 1 / pivot; a barrier; every thread subtracts it
//   from its rows and the owners of the next column publish that. Rows
//   are never swapped or rescaled once pivoted: a pivoted row keeps its
//   scale in a register and is scaled once, when c[p] | y[p] is written
//   to shared memory for the next layer's product; from there it goes to
//   the scratch for the back substitution in 16-byte vectors (its rows
//   are in each lane's pivot order, so stores from registers would
//   scatter). Two barriers a step.
// - lo[p + 1] is copied into shared memory with cp.async while layer p
//   eliminates, and di, up and r of layer p + 1 are prefetched into L2;
//   the back substitution prefetches the next layer's c | y.

#include <cuda_runtime.h>

#include <type_traits>

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

// ---------------------------------------------------------------------------
// The pivoting branch, 24 < K <= 48.
// ---------------------------------------------------------------------------

constexpr int PK = 48;  // its bound on K

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Shared-memory layout in elements of T, every region [..][lane]: lo of
// the layer [PK][PK][LW]; c | y of the previous layer [PK][PK + 1][LW];
// the published pivot column, double-buffered [2][PK][LW]; the published
// pivot row [2 PK + 1][LW] (denom part, up part, rhs); x[p+1] of the back
// substitution [2][PK][LW]. LW elements are 32 bytes, so every region is
// 32-byte aligned.
template <typename T, int LW, int RG, int CG>
struct Pivot {
  static constexpr int LANES = LW;
  static constexpr int ROWG = RG;
  static constexpr int COLG = CG;
  static constexpr int TPL = RG * CG;  // threads per lane
  static constexpr int NT = LW * TPL;  // threads per block
  static constexpr int MR = PK / RG;   // rows per thread
  static constexpr int MC = PK / CG;   // columns per thread in each half
  static constexpr int CS = PK + 1;    // row of c | y
  static constexpr int LO = 0;
  static constexpr int CB = LO + PK * PK * LW;
  static constexpr int COL = CB + PK * CS * LW;
  static constexpr int ROW = COL + 2 * PK * LW;
  static constexpr int XS = ROW + (2 * PK + 1) * LW;
  static constexpr int TOTAL = XS + 2 * PK * LW;
  static constexpr int SCRATCH = PK * CS * LW;  // c | y of one layer and block
  static_assert(LW * sizeof(T) == 32, "a lane group is one 32-byte sector");
  static_assert(PK % RG == 0 && PK % CG == 0 && NT % 32 == 0, "tiling");
  static_assert((32 / LW) <= CG && CG % (32 / LW) == 0,
                "a warp holds one row group");
};

// Copy lo[p] (rows and columns < K) for lanes w0 .. w0 + LW into `los`,
// V lanes a copy; lanes past W are zero-filled.
template <typename T, int LW, int NT, bool VEC>
__device__ __forceinline__ void pivot_load_lo(const T* lo, T* los, int p, int K, int W,
                                              int w0) {
  constexpr int V = VEC ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int PER = LW / V;
  const int items = K * K * PER;
  const T* base = lo + static_cast<long long>(p) * K * K * W;
  for (int it = threadIdx.x; it < items; it += NT) {
    const int ik = it / PER;
    const int part = it - ik * PER;
    const int i = ik / K;
    const int k = ik - i * K;
    const int wl = w0 + part * V;
    const bool valid = wl < W;
    const T* src = base + static_cast<long long>(ik) * W + wl;
    cp_async<T, V>(los + (i * PK + k) * LW + part * V, valid ? src : base, valid);
  }
}

template <typename T, int LW, int RG, int CG, bool VEC>
__global__ void __launch_bounds__(LW * RG * CG, 1)
thomas_pivot_kernel(const T* __restrict__ lo, const T* __restrict__ di,
                    const T* __restrict__ up, const T* __restrict__ r,
                    T* cy, T* __restrict__ x, int P, int K, int W) {
  using S = Pivot<T, LW, RG, CG>;
  constexpr int MR = S::MR;
  constexpr int MC = S::MC;
  constexpr int CS = S::CS;
  constexpr int NT = S::NT;
  constexpr int TW = 32 / LW;  // threads of one lane in a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* los = sm + S::LO;
  T* cb = sm + S::CB;
  T* colb = sm + S::COL;
  T* rowb = sm + S::ROW;
  T* xs = sm + S::XS;

  const int t = threadIdx.x;
  const int l = t % LW;        // lane of the block
  const int q = t / LW;        // tile of the lane
  const int g = q / CG;        // row group
  const int h = q % CG;        // column group
  const int qq = (t % 32) / LW;  // this thread's share of the arg-max scan
  const int w0 = blockIdx.x * LW;
  const int w = w0 + l;
  const bool live = w < W;
  const int wl = live ? w : W - 1;  // a dead lane reads a live lane's di, up, r
  const long long KW = static_cast<long long>(K) * W;
  const long long KKW = KW * K;
  const long long cy_layer = static_cast<long long>(gridDim.x) * S::SCRATCH;
  T* cy_blk = cy + static_cast<long long>(blockIdx.x) * S::SCRATCH;

  for (int e = t; e < S::COL; e += NT) sm[e] = T(0);  // lo and c | y padding
  __syncthreads();
  pivot_load_lo<T, LW, NT, VEC>(lo, los, 0, K, W, w0);
  cp_async_commit();

  T a[MR][MC];  // denom, columns h + CG n
  T u[MR][MC];  // up, then c[p], columns h + CG n
  T bb[MR];     // the rhs, then y[p] (column group 0)
  T rinv[MR];   // 1 / pivot of the step at which the row was pivoted
  int rstep[MR];

  // c[p] | y[p] from shared memory to the scratch, in 16-byte vectors: the
  // rows are in pivot order per lane, so a store from registers would
  // scatter over sectors
  auto store_cy = [&](int p) {
    constexpr int V = 16 / static_cast<int>(sizeof(T));
    using Vec = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
    const Vec* src = reinterpret_cast<const Vec*>(cb);
    Vec* dst = reinterpret_cast<Vec*>(cy_blk + p * cy_layer);
    for (int e = t; e < K * CS * LW / V; e += NT) dst[e] = src[e];
  };

  for (int p = 0; p < P; ++p) {
    // --- this thread's elements of di[p], up[p] and r[p] ----------------------
    const T* di_p = di + p * KKW;
    const T* up_p = up + p * KKW;
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      const int i = g + RG * m;
#pragma unroll
      for (int n = 0; n < MC; ++n) {
        const int j = h + CG * n;
        const bool in = i < K && j < K;
        const long long o = static_cast<long long>(i * K + j) * W + wl;
        a[m][n] = in ? di_p[o] : T(0);
        u[m][n] = in ? up_p[o] : T(0);
      }
      bb[m] = (h == 0 && i < K) ? r[p * KW + static_cast<long long>(i) * W + wl] : T(0);
      rinv[m] = T(0);
      rstep[m] = 0;
    }
    cp_async_wait_all();
    __syncthreads();  // lo[p] and c[p-1] | y[p-1] are in shared memory
    if (p > 0) store_cy(p - 1);

    // --- denom = di - lo c[p-1], rhs = r - lo y[p-1] ----------------------------
    if (p > 0) {
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        T lv[MR], cv[MC];
#pragma unroll
        for (int m = 0; m < MR; ++m) lv[m] = los[((g + RG * m) * PK + k) * LW + l];
#pragma unroll
        for (int n = 0; n < MC; ++n) cv[n] = cb[(k * CS + h + CG * n) * LW + l];
#pragma unroll
        for (int m = 0; m < MR; ++m) {
#pragma unroll
          for (int n = 0; n < MC; ++n) a[m][n] -= lv[m] * cv[n];
        }
        if (h == 0) {
          const T yk = cb[(k * CS + PK) * LW + l];
#pragma unroll
          for (int m = 0; m < MR; ++m) bb[m] -= lv[m] * yk;
        }
      }
    }
    if (h == 0) {  // publish column 0
#pragma unroll
      for (int m = 0; m < MR; ++m) colb[(g + RG * m) * LW + l] = a[m][0];
    }

    // --- Gauss-Jordan with partial pivoting ------------------------------------
    // rows past K count as pivoted from the start, so never chosen
    unsigned long long pivoted = ~((1ull << K) - 1ull);
    for (int s = 0; s < K; ++s) {
      const T* col = colb + (s & 1) * PK * LW;
      __syncthreads();  // column s published; the row buffer is free
      if (s == 0 && p + 1 < P) {
        // lo is free (the product is done): copy the next layer's, and
        // bring its di, up and r into L2
        pivot_load_lo<T, LW, NT, VEC>(lo, los, p + 1, K, W, w0);
        cp_async_commit();
        const int kk = K * K;
        const T* dn = di + (p + 1) * KKW + w0;
        const T* un = up + (p + 1) * KKW + w0;
        const T* rn = r + (p + 1) * KW + w0;
        for (int it = t; it < 2 * kk + K; it += NT) {
          const T* src = it < kk ? dn + static_cast<long long>(it) * W
                                 : (it < 2 * kk ? un + static_cast<long long>(it - kk) * W
                                                : rn + static_cast<long long>(it - 2 * kk) * W);
          prefetch_l2(src);
        }
      }
      // the pivot: the largest |column s| over the unpivoted rows, the
      // lowest row on ties; NaN is never chosen
      T best = T(-1);
      int bi = PK;
#pragma unroll
      for (int rr = 0; rr < PK / TW; ++rr) {
        const int i = qq + TW * rr;
        const T v = ((pivoted >> i) & 1ull) ? T(-1) : fabs(col[i * LW + l]);
        if (v > best) {
          best = v;
          bi = i;
        }
      }
#pragma unroll
      for (int o = LW; o < 32; o <<= 1) {
        const T ob = __shfl_xor_sync(FULL, best, o);
        const int oi = __shfl_xor_sync(FULL, bi, o);
        if (ob > best || (ob == best && oi < bi)) {
          best = ob;
          bi = oi;
        }
      }
      const int piv = bi < PK ? bi : __ffsll(static_cast<long long>(~pivoted)) - 1;
      pivoted |= 1ull << piv;
      const T inv = T(1) / col[piv * LW + l];
      const int mp = piv / RG;
      // the pivot row's owners publish it scaled by 1 / pivot
      if (g == piv - RG * mp) {
#pragma unroll
        for (int n = 0; n < MC; ++n) {
          T va = a[0][n], vu = u[0][n];
#pragma unroll
          for (int m = 1; m < MR; ++m) {
            va = mp == m ? a[m][n] : va;
            vu = mp == m ? u[m][n] : vu;
          }
          rowb[(h + CG * n) * LW + l] = va * inv;
          rowb[(PK + h + CG * n) * LW + l] = vu * inv;
        }
        if (h == 0) {
          T vb = bb[0];
#pragma unroll
          for (int m = 1; m < MR; ++m) vb = mp == m ? bb[m] : vb;
          rowb[2 * PK * LW + l] = vb * inv;
        }
      }
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const bool is = g + RG * m == piv;
        rinv[m] = is ? inv : rinv[m];
        rstep[m] = is ? s : rstep[m];
      }
      __syncthreads();  // the pivot row is published

      // every other row: row -= (its column s) x the scaled pivot row
      T f[MR];
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const int i = g + RG * m;
        f[m] = i == piv ? T(0) : col[i * LW + l];
      }
#pragma unroll
      for (int n = 0; n < MC; ++n) {
        if (CG * n + CG - 1 > s) {  // columns <= s are done
          const T rv = rowb[(h + CG * n) * LW + l];
#pragma unroll
          for (int m = 0; m < MR; ++m) a[m][n] -= f[m] * rv;
        }
        const T rv = rowb[(PK + h + CG * n) * LW + l];
#pragma unroll
        for (int m = 0; m < MR; ++m) u[m][n] -= f[m] * rv;
      }
      if (h == 0) {
        const T rv = rowb[2 * PK * LW + l];
#pragma unroll
        for (int m = 0; m < MR; ++m) bb[m] -= f[m] * rv;
      }
      // the owners of column s + 1 publish it
      T* cn = colb + ((s + 1) & 1) * PK * LW;
#pragma unroll
      for (int n = 0; n < MC; ++n) {
        if (h + CG * n == s + 1) {
#pragma unroll
          for (int m = 0; m < MR; ++m) cn[(g + RG * m) * LW + l] = a[m][n];
        }
      }
    }

    // --- c[p] | y[p]: row rstep of the solution, scaled once, into shared
    // memory for the next layer's product; the next barrier hands it to
    // store_cy
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      if (g + RG * m < K) {
        T* dst = cb + rstep[m] * CS * LW + l;
#pragma unroll
        for (int n = 0; n < MC; ++n) dst[(h + CG * n) * LW] = u[m][n] * rinv[m];
        if (h == 0) dst[PK * LW] = bb[m] * rinv[m];
      }
    }
  }
  __syncthreads();
  store_cy(P - 1);

  // --- back substitution, layer P-1 down to 0: thread q < K takes row q ----------
  __syncthreads();  // the block's c | y stores are visible to the block
  for (int p = P - 1; p >= 0; --p) {
    const T* cy_p = cy_blk + p * cy_layer;
    if (p > 0) {
      const T* nxt = cy_p - cy_layer;
      for (int e = t * (32 / sizeof(T)); e < K * CS * LW; e += NT * (32 / sizeof(T))) {
        prefetch_l2(nxt + e);
      }
    }
    if (q < K) {
      const T* row = cy_p + q * CS * LW + l;
      T acc[4] = {row[PK * LW], T(0), T(0), T(0)};
      if (p < P - 1) {
        const T* xn = xs + ((p + 1) & 1) * PK * LW + l;
        int j = 0;
        for (; j + 4 <= K; j += 4) {
#pragma unroll
          for (int d = 0; d < 4; ++d) acc[d] -= row[(j + d) * LW] * xn[(j + d) * LW];
        }
        for (; j < K; ++j) acc[0] -= row[j * LW] * xn[j * LW];
      }
      const T v = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      xs[(p & 1) * PK * LW + q * LW + l] = v;
      if (live) x[p * KW + static_cast<long long>(q) * W + w] = v;
    }
    __syncthreads();
  }
}

// The pivoting branch's tiling per type: LW lanes a block, RG row groups,
// CG column groups.
template <typename T>
struct PivotTiling;
template <>
struct PivotTiling<float> {
  using S = Pivot<float, 8, 16, 4>;
};
template <>
struct PivotTiling<double> {
  using S = Pivot<double, 4, 16, 8>;
};

template <typename T>
int launch_pivot(const void* lo, const void* di, const void* up, const void* r, void* cy,
                 void* x, int P, int K, int W, cudaStream_t stream) {
  using S = typename PivotTiling<T>::S;
  const size_t shared = static_cast<size_t>(S::TOTAL) * sizeof(T);
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const bool vec = W % V == 0 && aligned16(lo);
  auto kernel = vec ? thomas_pivot_kernel<T, S::LANES, S::ROWG, S::COLG, true>
                    : thomas_pivot_kernel<T, S::LANES, S::ROWG, S::COLG, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (W + S::LANES - 1) / S::LANES;
  kernel<<<blocks, S::NT, shared, stream>>>(
      static_cast<const T*>(lo), static_cast<const T*>(di), static_cast<const T*>(up),
      static_cast<const T*>(r), static_cast<T*>(cy), static_cast<T*>(x), P, K, W);
  return static_cast<int>(cudaGetLastError());
}

// K <= 24: v3, with 16-byte copies where every tile row starts 16-byte
// aligned (W a multiple of the elements per copy), element copies
// otherwise. 24 < K <= 48: the pivoting branch.
template <typename T, int LW>
int launch(const void* lo, const void* di, const void* up, const void* r, void* c,
           void* y, void* x, int P, int K, int W, void* stream) {
  if (P < 1 || K < 1 || K > PK || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K > 24) return launch_pivot<T>(lo, di, up, r, c, x, P, K, W, s);  // c: its scratch
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

// Elements of the scratch buffer c for one layer: v3's c[p] [K, K, W],
// or the pivoting branch's c | y of every block [PK][PK + 1][LW]. The
// caller allocates P times this; v3 also takes y [P, K, W].
template <typename S>
int pivot_scratch(int W) {
  return (W + S::LANES - 1) / S::LANES * S::SCRATCH;
}

extern "C" int thomas_scratch_per_layer(int K, int W, int is_f64) {
  if (K <= 24) return K * K * W;
  return is_f64 ? pivot_scratch<PivotTiling<double>::S>(W)
                : pivot_scratch<PivotTiling<float>::S>(W);
}

extern "C" int thomas_solve_f64(const void* lo, const void* di, const void* up,
                                const void* r, void* c, void* y, void* x,
                                int P, int K, int W, void* stream) {
  return launch<double, 4>(lo, di, up, r, c, y, x, P, K, W, stream);
}
