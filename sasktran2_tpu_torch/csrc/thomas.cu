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
// product lo c[p-1] and the solve of a 48 x 48 block for 49 right-hand
// sides; counted as LU with partial pivoting, 53.9 GFLOP for
// [100, 48, 48, 1024] (0.80 ms at the FP32 rate; Gauss-Jordan, as here,
// does 68.9), under the 0.86 ms that its 2.87 GB of operands take at the
// memory rate; but each of the 1024 systems is serial over P
// layers and 48 pivot steps a layer, and each step is a column arg-max
// whose pivot row every thread of the lane must see. Tensor cores are no
// route: the products stay in full FP32 (no TF32). So the time is the
// chain of a step (the factors and the pivot row arrive, update, search,
// publish) times 4,800 steps, and the design shortens that chain and
// lets the SM's lanes run theirs apart:
// - A synchronisation domain per lane. f32: one warp holds a lane's
//   system in registers, thread tl owning rows g + 16 m (g = tl / 2,
//   m < 3) and columns h + 2 n (h = tl % 2) of denom (n < 24) and of
//   [up | rhs] (n < 25; column 48 the rhs): 147 registers of system,
//   229 a thread, no spill; 8 lanes, 256 threads, a block and an SM. A
//   step synchronises the warp alone, so the 8 lanes of an SM run their
//   chains independently. f64: two warps a lane, the column groups split
//   between them, a named barrier (bar.sync 1 + lane, 64) a step.
// - The pivot searched a step ahead. Step s ends with the warp owning
//   column s + 1 finding that column's pivot by two redux.sync (the max
//   of a key that orders |a| and puts NaN below every number, then the
//   min row among the keys equal to it: the lowest row on ties, NaN never
//   chosen), publishing the pivot row and writing the factors (column
//   over pivot) of step s + 1, so a step is one warp sync, not the two
//   block-wide barriers with a serial arg-max between them of the
//   branch's first, block-synchronous design. The search runs after the
//   step's update, not beside it: beside, ptxas issues its dependent
//   reductions amid the FMAs and the step took longer. Rows are never
//   swapped or rescaled once pivoted; a pivoted row is scaled once,
//   when c[p] | y[p] is written.
// - The steps run in chunks of 8, each unrolled, so that every register
//   index is a constant; between chunks the denom registers move down by
//   a chunk's slots (9 moves a step), and from step 24 on the upper half,
//   zeros moved in, is left out. All 48 steps unrolled were 240 KB of
//   code and ran slower than the first design (instruction fetch); a
//   rolled loop takes column s + 1 out of the registers through a branch
//   tree. Every denom column is updated in every step, those at or before
//   s too (not read again): cheaper than branching past them.
// - Lane-major warps would read the W-minor operands 4 bytes a sector, so
//   lo, di and up of the next layer are copied into each lane's layout in
//   shared memory by one-element cp.async (4 bytes in f32, 8 in f64),
//   LW threads on the LW lanes of one element (whole sectors a warp),
//   32 / LW elements of a lane a warp
//   (distinct banks), one part a step in the first steps of the chunks
//   (in one burst the copies stall the step chains); two block barriers
//   a layer (copies landed; every lane done with the buffers). 231,552
//   bytes of shared memory a block in f32 (231,168 in f64; a block may
//   have 232,448): lo^T, up, c[p-1] (di[p] before it), two factor
//   records and two pivot-row buffers a lane. c[p] | y[p] go to the
//   scratch in 16-byte vectors; warp 0 of each lane does the back
//   substitution, each layer's record brought into shared memory by
//   cp.async a layer ahead.
// Variants and the cost of each part: tools/probe_thomas_pivot.py, with
// its times in PERF.md. The first design's tilings (RG x CG threads a
// lane, 8 lanes a block, two block barriers a step) ran 16 x 4 at
// 8.95 ms, 8 x 8 at 10.5 ms and 4 x 16, spilling, at 13.8 ms.

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

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// The WPL warps of one lane meet: the warp alone, or named barrier
// 1 + lane over the lane's 32 WPL threads (barrier 0 is __syncthreads).
template <int WPL>
__device__ __forceinline__ void lane_sync(int lane) {
  if constexpr (WPL == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + lane), "n"(32 * WPL) : "memory");
  }
}

// The pivot search's key of v: a larger |v| has a larger key; NaN has 0,
// below every number (0 has 1).
__device__ __forceinline__ unsigned pivot_key(float v) {
  const unsigned b = __float_as_uint(fabsf(v));
  return b <= 0x7f800000u ? b + 1u : 0u;
}

__device__ __forceinline__ unsigned long long pivot_key(double v) {
  const auto b = static_cast<unsigned long long>(__double_as_longlong(fabs(v)));
  return b <= 0x7ff0000000000000ull ? b + 1ull : 0ull;
}

// The largest key of the warp, in every thread: one redux.sync, or two
// for a 64-bit key (its high word, then the low word where the high one
// is the largest).
__device__ __forceinline__ unsigned warp_max(unsigned k) {
  return __reduce_max_sync(FULL, k);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long k) {
  const unsigned hi = __reduce_max_sync(FULL, static_cast<unsigned>(k >> 32));
  const unsigned lo = __reduce_max_sync(
      FULL, static_cast<unsigned>(k >> 32) == hi ? static_cast<unsigned>(k) : 0u);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// A block holds LW lanes (wavelengths), WPL warps each, a lane's threads
// consecutive. Thread tl of the lane's warp wq owns rows g + RG m
// (g = tl / 2, m < MR) and columns hh + CG n of denom (n < MCL) and of
// [up | rhs] (n < MCR; column 48 is the rhs, in group 0, and the others
// past 47 stay 0), hh = 2 wq + tl % 2.
// Shared memory per lane, in elements of T, every region 16-byte
// aligned: lo[p] transposed, [k][i] (LO); up[p], [i][j'] (ST); c[p-1],
// [k][j'], and before it di[p], [i][j'] (CY); two factor records
// [2][FW] (FR: f[48], the pivot row, 1 / pivot), the first of which holds
// y[p-1] between layers; two pivot rows [2][CG][PW] (PR: each column
// group's part, its denom columns then its [up | rhs] columns). j' =
// (j % CG) MCL + j / CG puts a thread's columns side by side, so that it
// reads its part of a row as 16-byte vectors.
template <typename T, int LW, int WPL>
struct Pivot {
  static constexpr int LANES = LW;
  static constexpr int WARPS = WPL;
  static constexpr int NT = 32 * WPL * LW;  // threads a block
  static constexpr int RG = 16;             // row groups
  static constexpr int MR = PK / RG;        // rows a thread
  static constexpr int CG = 2 * WPL;        // column groups, two a warp
  static constexpr int MCL = PK / CG;       // denom columns a thread
  static constexpr int MCR = MCL + 1;       // [up | rhs] columns a thread
  static constexpr int V = 16 / static_cast<int>(sizeof(T));  // a 16-byte vector
  static constexpr int RL = round_up(MCL, V);  // the [up | rhs] part of a group
  static constexpr int PW = RL + round_up(MCR, V);
  static constexpr int FW = PK + 4;
  static constexpr int LO = 0;
  static constexpr int ST = LO + PK * PK;
  static constexpr int CY = ST + PK * PK;
  static constexpr int FR = CY + PK * PK;
  static constexpr int PR = FR + 2 * FW;
  // a lane's region, padded so that a warp's copies (32 / LW consecutive
  // elements of each of the LW lanes) fall in distinct banks
  static constexpr int BANKS = 128 / static_cast<int>(sizeof(T));
  static constexpr int LANE =
      PR + 2 * CG * PW + ((32 / LW - (PR + 2 * CG * PW)) % BANKS + BANKS) % BANKS;
  static constexpr int TOTAL = LW * LANE;
  static constexpr int REC = PK * PK + PK;  // c | y of a lane and layer, scratch
  static constexpr int SCRATCH = LW * REC;  // the scratch of a block and layer
  static_assert(LW * sizeof(T) == 32, "a block's lanes are one 32-byte sector");
  static_assert(MCL % V == 0 && FW % V == 0 && PW % V == 0 && LANE % V == 0,
                "16-byte alignment");
  static_assert(TOTAL * sizeof(T) <= 232448, "shared memory of a block");
};

template <typename T, int LW, int WPL>
__global__ void __launch_bounds__(32 * WPL * LW, 1)
thomas_pivot_kernel(const T* __restrict__ lo, const T* __restrict__ di,
                    const T* __restrict__ up, const T* __restrict__ r,
                    T* __restrict__ cy, T* __restrict__ x, int P, int K, int W) {
  using S = Pivot<T, LW, WPL>;
  constexpr int RG = S::RG;
  constexpr int MR = S::MR;
  constexpr int CG = S::CG;
  constexpr int MCL = S::MCL;
  constexpr int MCR = S::MCR;
  constexpr int V = S::V;
  constexpr int RL = S::RL;
  constexpr int PW = S::PW;
  constexpr int FW = S::FW;
  constexpr int NT = S::NT;
  constexpr int LT = 32 * WPL;  // threads a lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);

  const int t = threadIdx.x;
  const int lane = t / LT;
  const int tq = t % LT;  // thread of the lane
  const int wq = WPL == 1 ? 0 : tq / 32;  // warp of the lane
  const int tl = t % 32;
  const int g = tl / 2;
  const int hh = 2 * wq + tl % 2;
  const int w0 = blockIdx.x * LW;
  const int w = w0 + lane;
  const bool live = w < W;
  const int wr = live ? w : W - 1;  // a dead lane reads a live lane's r
  T* const ls = sm + lane * S::LANE;
  T* const fr = ls + S::FR;
  T* const pr = ls + S::PR;
  const long long KW = static_cast<long long>(K) * W;
  const long long rec_layer = static_cast<long long>(gridDim.x) * S::SCRATCH;
  T* const rec0 = cy + (static_cast<long long>(blockIdx.x) * LW + lane) * S::REC;

  T a[MR][MCL];  // denom
  T u[MR][MCR];  // [up | rhs], then c[p] | y[p] (rows unscaled, in pivot order)
  T rn[MR];      // r of the next layer (column group 0)
  T rinv[MR];    // 1 / pivot of the step that pivoted the row
  int rstep[MR];
  unsigned free_rows = 0;  // bit m: row g + RG m is below K and not pivoted yet
  int ps = 0;              // the step's pivot row and 1 / pivot
  T inv = T(0);

  // Layer p's lo, di and up of the block's lanes into LO, CY and ST, RPS
  // rows of each a call (`part` of the PARTS of a layer, PPC a chunk of
  // the elimination): LW consecutive threads copy one element of the LW
  // lanes, so that every warp reads whole 32-byte sectors, and 32 / LW
  // consecutive elements of each lane's layout, so that its shared stores
  // fall in distinct banks. Elements past K are 0.
  constexpr int STEP = NT / LW;             // elements of a lane a pass of the block
  constexpr int CPS = 3;                    // passes a call
  constexpr int RPS = CPS * STEP / PK;      // rows a call
  constexpr int PARTS = PK / RPS;           // calls a layer
  constexpr int SC = 8;                     // steps a chunk of the elimination
  constexpr int SH = SC / CG;               // denom slots a chunk
  constexpr int MIN_CHUNKS = (PK / 2 + SC) / SC;  // chunks at the least K, 25
  constexpr int PPC = (PARTS + MIN_CHUNKS - 1) / MIN_CHUNKS;  // copy calls a chunk
  static_assert(CPS * STEP % PK == 0 && PK % RPS == 0, "copy passes");
  static_assert(SC % CG == 0 && MCL % SH == 0 && PPC <= SC && MCL / V % 2 == 0, "chunks");
  const int cl = t % LW;
  T* const cdst = sm + cl * S::LANE + t / LW;
  const int cw = min(w0 + cl, W - 1);  // a dead lane copies a live one
  int ca[CPS], cb[CPS], cj[CPS];  // per pass: row offset, column in LO, in CY / ST
#pragma unroll
  for (int c = 0; c < CPS; ++c) {
    const int e = c * STEP + t / LW;
    ca[c] = e / PK;
    cb[c] = e % PK;
    cj[c] = cb[c] / MCL + CG * (cb[c] % MCL);
  }
  auto copy_part = [&](int p, int part) {
    const long long layer = static_cast<long long>(p) * K * KW + cw;
#pragma unroll
    for (int c = 0; c < CPS; ++c) {
      const int row = RPS * part + ca[c];
      T* const d = cdst + RPS * part * PK + c * STEP;
      // lo[p][cb][row] -> LO[row][cb]; di, up [row][cj] -> CY, ST [row][cb];
      // zeros past K
      const bool in_lo = row < K && cb[c] < K;
      const bool in_d = row < K && cj[c] < K;
      const long long ol = layer + static_cast<long long>(in_lo ? cb[c] * K + row : 0) * W;
      const long long od = layer + static_cast<long long>(in_d ? row * K + cj[c] : 0) * W;
      cp_async<T, 1>(d + S::LO, lo + ol, in_lo);
      cp_async<T, 1>(d + S::CY, di + od, in_d);
      cp_async<T, 1>(d + S::ST, up + od, in_d);
    }
    cp_async_commit();
  };

  auto load_r = [&](int p) {
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      const int i = g + RG * m;
      rn[m] = (hh == 0 && i < K) ? r[p * KW + static_cast<long long>(i) * W + wr] : T(0);
    }
  };

  // c[p] | y[p] into CY and the first factor record: the row pivoted at
  // step k is row k of the solution, scaled once; rows past K are 0
  auto write_cy = [&]() {
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      const int i = g + RG * m;
      const bool real = i < K;
      const int row = real ? rstep[m] : i;
      T v[MCL];
#pragma unroll
      for (int n = 0; n < MCL; ++n) v[n] = real ? u[m][n] * rinv[m] : T(0);
      sts_vec<T, MCL>(ls + S::CY + row * PK + hh * MCL, v);
      if (hh == 0) fr[row] = real ? u[m][MCL] * rinv[m] : T(0);
    }
  };

  // c[p] | y[p] of the lane from CY and FR to its scratch record, in
  // 16-byte vectors, for the back substitution
  auto store_rec = [&](int p) {
    using Vec = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
    const Vec* src = reinterpret_cast<const Vec*>(ls + S::CY);
    Vec* dst = reinterpret_cast<Vec*>(rec0 + p * rec_layer);
    for (int e = tq; e < PK * PK / V; e += LT) dst[e] = src[e];
    if (tq < PK / V) dst[PK * PK / V + tq] = reinterpret_cast<const Vec*>(fr)[tq];
  };

  // The pivot of a column among the rows not yet pivoted: the largest |v|,
  // the lowest row on ties, NaN never chosen. v[m] is row g + RG m of the
  // column in the threads with tl % 2 == hc. The column's warp calls it
  // and every thread of it gets the row, and its value in vp.
  auto find_pivot = [&](const T (&v)[MR], int hc, T& vp) -> int {
    using Key = decltype(pivot_key(T(0)));
    const bool own = tl % 2 == hc;
    Key key[MR];
    Key best = 0;
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      key[m] = (own && ((free_rows >> m) & 1u)) ? pivot_key(v[m]) : Key(0);
      best = key[m] > best ? key[m] : best;
    }
    const Key top = warp_max(best);
    unsigned cand = PK;
#pragma unroll
    for (int m = MR - 1; m >= 0; --m) {
      if (own && ((free_rows >> m) & 1u) && key[m] == top) cand = g + RG * m;
    }
    const int piv = static_cast<int>(__reduce_min_sync(FULL, cand));
    const int mp = piv / RG;
    T vs = v[0];
#pragma unroll
    for (int m = 1; m < MR; ++m) vs = mp == m ? v[m] : vs;
    vp = __shfl_sync(FULL, vs, 2 * (piv - RG * mp) + hc);
    return piv;
  };

  // This thread's part of row R, as it stands, into pivot-row buffer b;
  // its denom slots moved down by sh (a constant: 0, or SH when the row
  // is read in the next chunk)
  auto publish = [&](int R, int b, int sh) {
    if (g != R % RG) return;
    T* const dst = pr + (b * CG + hh) * PW;
    const int mr = R / RG;
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      if (m == mr) {
#pragma unroll
        for (int q = 0; q < MCL / V; ++q) {
          T v[V];
#pragma unroll
          for (int d = 0; d < V; ++d) {
            const int n = q * V + d + sh;
            v[d] = n < MCL ? a[m][n] : T(0);
          }
          sts_vec<T, V>(dst + q * V, v);
        }
#pragma unroll
        for (int q = 0; q < round_up(MCR, V) / V; ++q) {
          T v[V];
#pragma unroll
          for (int d = 0; d < V; ++d) v[d] = q * V + d < MCR ? u[m][q * V + d] : T(0);
          sts_vec<T, V>(dst + RL + q * V, v);
        }
      }
    }
  };

  for (int e = t; e < S::TOTAL; e += NT) sm[e] = T(0);  // the padding past K
  __syncthreads();
  for (int part = 0; part < PARTS; ++part) copy_part(0, part);
  load_r(0);

  for (int p = 0; p < P; ++p) {
    cp_async_wait_all();
    __syncthreads();  // layer p's lo, di and up are in shared memory
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      lds_vec<T, MCL>(a[m], ls + S::CY + (g + RG * m) * PK + hh * MCL);
    }
    lane_sync<WPL>(lane);  // di[p] is read before c[p-1] takes its place
    if (p > 0) write_cy();
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      lds_vec<T, MCL>(u[m], ls + S::ST + (g + RG * m) * PK + hh * MCL);
      u[m][MCL] = rn[m];
    }
    lane_sync<WPL>(lane);  // c[p-1] | y[p-1] are in CY and FR

    // --- denom = di - lo c[p-1], rhs = r - lo y[p-1] --------------------------
    if (p > 0) {
      store_rec(p - 1);
      const T* lt = ls + S::LO + g;
      const T* ct = ls + S::CY + hh * MCL;
#pragma unroll 2
      for (int k = 0; k < K; ++k) {
        T lv[MR], cv[MCL];
#pragma unroll
        for (int m = 0; m < MR; ++m) lv[m] = lt[k * PK + RG * m];
        lds_vec<T, MCL>(cv, ct + k * PK);
        const T yk = hh == 0 ? fr[k] : T(0);
#pragma unroll
        for (int m = 0; m < MR; ++m) {
#pragma unroll
          for (int n = 0; n < MCL; ++n) a[m][n] -= lv[m] * cv[n];
          u[m][MCL] -= lv[m] * yk;
        }
      }
    }
    __syncthreads();  // every lane is done with LO, ST and CY
    if (p + 1 < P) load_r(p + 1);

    // --- Gauss-Jordan with partial pivoting, the pivot searched ahead ---------
    free_rows = 0;
#pragma unroll
    for (int m = 0; m < MR; ++m) free_rows |= (g + RG * m < K ? 1u : 0u) << m;
    if (wq == 0) {  // column 0: warp 0, group 0
      T v[MR];
#pragma unroll
      for (int m = 0; m < MR; ++m) v[m] = a[m][0];
      T vp;
      const int p0 = find_pivot(v, 0, vp);
      const T i0 = T(1) / vp;
      if (tl % 2 == 0) {
#pragma unroll
        for (int m = 0; m < MR; ++m) fr[g + RG * m] = g + RG * m == p0 ? T(0) : v[m] * i0;
      }
      if (WPL > 1 && tl == 0) {
        fr[PK] = T(p0);
        fr[PK + 1] = i0;
      }
      ps = p0;
      inv = i0;
      publish(p0, 0, 0);
    }
    lane_sync<WPL>(lane);

    // The steps in chunks of SC, each unrolled, so that every register
    // index is a constant: in a chunk from step c0, denom slot n holds
    // columns hh + CG n + c0 (the slots move down by SH after each chunk).
    for (int c0 = 0; c0 < K; c0 += SC) {
#pragma unroll
      for (int k = 0; k < SC; ++k) {
        // the next layer's copies, PPC parts a chunk from its first steps
        if (k < PPC && c0 / SC * PPC + k < PARTS && p + 1 < P) copy_part(p + 1, c0 / SC * PPC + k);
        const int s = c0 + k;
        if (s < K) {
          const int b = s & 1;
          const T* const frs = fr + b * FW;
          if constexpr (WPL > 1) {
            ps = static_cast<int>(frs[PK]);
            inv = frs[PK + 1];
          }
          T f[MR];  // row -= f x (the pivot row): its column s over the pivot
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            f[m] = frs[g + RG * m];
            if (g + RG * m == ps) {
              free_rows &= ~(1u << m);
              rstep[m] = s;
              rinv[m] = inv;
            }
          }
          if (WPL > 1 && wq != (k % CG) / 2) {  // not column s's warp: publish now
            publish(ps, b, 0);
            __syncwarp();
          }
          const T* const prow = pr + (b * CG + hh) * PW;
#pragma unroll
          for (int q = 0; q < round_up(MCR, V) / V; ++q) {
            T pv[V];
            lds_vec<T, V>(pv, prow + RL + q * V);
#pragma unroll
            for (int d = 0; d < V; ++d) {
              const int n = q * V + d;
              if (n < MCR) {
#pragma unroll
                for (int m = 0; m < MR; ++m) u[m][n] -= f[m] * pv[d];
              }
            }
          }
          // denom (none after the last step): every slot, those of columns
          // at or before s too (they are not read again), which costs less
          // than the branches that would skip them; from step 24 on the
          // upper half of the slots holds zeros moved in and is left out
          const bool ahead = s + 1 < K;
          auto denom = [&](int q) {
            T pv[V];
            lds_vec<T, V>(pv, prow + q * V);
#pragma unroll
            for (int d = 0; d < V; ++d) {
#pragma unroll
              for (int m = 0; m < MR; ++m) a[m][q * V + d] -= f[m] * pv[d];
            }
          };
          if (ahead) {
#pragma unroll
            for (int q = 0; q < MCL / V / 2; ++q) denom(q);
            if (c0 < PK / 2) {
#pragma unroll
              for (int q = MCL / V / 2; q < MCL / V; ++q) denom(q);
            }
          }
          // the next column: its warp, group and slot are constants
          const int c1 = k + 1;
          if (ahead && wq == (c1 % CG) / 2) {
            T v[MR];
#pragma unroll
            for (int m = 0; m < MR; ++m) v[m] = a[m][c1 / CG];
            T vp;
            const int ps1 = find_pivot(v, c1 % 2, vp);
            // step s + 1 reads its pivot row in its chunk's slots
            publish(ps1, b ^ 1, k == SC - 1 ? SH : 0);
            const T inv1 = T(1) / vp;
            T* const fn = fr + (b ^ 1) * FW;
            if (tl % 2 == c1 % 2) {
#pragma unroll
              for (int m = 0; m < MR; ++m) fn[g + RG * m] = g + RG * m == ps1 ? T(0) : v[m] * inv1;
            }
            if (WPL > 1 && tl == 0) {
              fn[PK] = T(ps1);
              fn[PK + 1] = inv1;
            }
            ps = ps1;
            inv = inv1;
          }
          lane_sync<WPL>(lane);
        }
      }
#pragma unroll
      for (int m = 0; m < MR; ++m) {
#pragma unroll
        for (int n = 0; n < MCL; ++n) a[m][n] = n + SH < MCL ? a[m][n + SH] : T(0);
      }
    }
  }
  lane_sync<WPL>(lane);
  write_cy();
  lane_sync<WPL>(lane);
  store_rec(P - 1);
  lane_sync<WPL>(lane);  // the lane's scratch records are visible to its warp 0

  // --- back substitution, layer P-1 down to 0, by warp 0 of each lane --------
  // thread (g, h) takes rows g + RG m and the column groups h, h + 2, ...;
  // the next layer's record comes into shared memory (LO, ST, CY: free
  // now) by cp.async while this one is summed, and the one after into L2
  if (wq == 0) {
    const int h = tl % 2;
    T* const xs = pr;          // x[p + 1], [2][PK], row i at (i % CG) MCL + i / CG
    T* const rb = ls + S::LO;  // two records, [2][REC]
    static_assert(2 * S::REC <= S::FR - S::LO, "back substitution buffers");
    auto fetch = [&](int p) {
      const T* src = rec0 + p * rec_layer;
      T* dst = rb + (p & 1) * S::REC;
      for (int e = tl * V; e < S::REC; e += 32 * V) cp_async<T, V>(dst + e, src + e, true);
      cp_async_commit();
      if (p > 0) {
        constexpr int LINE = 128 / static_cast<int>(sizeof(T));
        for (int e = tl * LINE; e < S::REC; e += 32 * LINE) prefetch_l2(src - rec_layer + e);
      }
    };
    fetch(P - 1);
    for (int p = P - 1; p >= 0; --p) {
      if (p > 0) {
        fetch(p - 1);
        cp_async_wait_1();
      } else {
        cp_async_wait_all();
      }
      __syncwarp();  // layer p's record is in shared memory
      const T* rec = rb + (p & 1) * S::REC;
      T acc[MR];
#pragma unroll
      for (int m = 0; m < MR; ++m) acc[m] = h == 0 ? rec[PK * PK + g + RG * m] : T(0);
      if (p < P - 1) {
        const T* xn = xs + ((p + 1) & 1) * PK;
#pragma unroll
        for (int q = 0; q < WPL; ++q) {
          const int grp = h + 2 * q;
          T xv[MCL];
          lds_vec<T, MCL>(xv, xn + grp * MCL);
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            T cv[MCL];
            lds_vec<T, MCL>(cv, rec + (g + RG * m) * PK + grp * MCL);
#pragma unroll
            for (int n = 0; n < MCL; ++n) acc[m] -= cv[n] * xv[n];
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MR; ++m) acc[m] += __shfl_xor_sync(FULL, acc[m], 1);
      if (h == 0) {
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const int i = g + RG * m;
          xs[(p & 1) * PK + (i % CG) * MCL + i / CG] = acc[m];
          if (live && i < K) x[p * KW + static_cast<long long>(i) * W + w] = acc[m];
        }
      }
      __syncwarp();  // the record and x[p + 1] are read before they are replaced
    }
  }
}

// The pivoting branch's shape per type: LW lanes a block, WPL warps a
// lane (f32: a warp holds a lane's 48 x 97 system in 147 registers a
// thread; f64: two warps, 150 registers a thread).
template <typename T>
struct PivotTiling;
template <>
struct PivotTiling<float> {
  using S = Pivot<float, 8, 1>;
};
template <>
struct PivotTiling<double> {
  using S = Pivot<double, 4, 2>;
};

template <typename T>
int launch_pivot(const void* lo, const void* di, const void* up, const void* r, void* cy,
                 void* x, int P, int K, int W, cudaStream_t stream) {
  using S = typename PivotTiling<T>::S;
  const size_t shared = static_cast<size_t>(S::TOTAL) * sizeof(T);
  auto kernel = thomas_pivot_kernel<T, S::LANES, S::WARPS>;
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
// or the pivoting branch's c | y of every block, [LW][PK * PK + PK]. The
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
