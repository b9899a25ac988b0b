// Device body of the monolithic staged IPM: one thread block solves one
// scenario's whole NT-Mehrotra predictor-corrector SOCP, as the plain
// version `_solve_block` in scpp_tpu_torch/solver/ipm_mono.py does for a
// batch. See mono_ipm.cu for the kernel entry, the memory plan and what
// bounds it on the card.
//
// Layouts (per scenario, row-major):
//   AT (K, 2w, me)  GT (K, 2w, mc)  rows of stage k act on [x_k | x_{k+1}]
//   x (K, w)  y (K, me)  s, z (K, mc)
//   cones per stage: [nonneg (l) | SOC q_1 | ... | SOC q_S]
// Every block-wide loop below is block-strided over threads and every
// block-wide phase ends in __syncthreads(); scalars of the scenario come
// from block reductions, so all control flow is uniform across the block.
// The KKT factor is cyclic reduction: its block factors run one warp per
// block, synchronised by __syncwarp() and shuffles alone (a warp of the
// last, partial group of threads has fewer lanes). The block reductions
// take a thread count that is a multiple of 32 or a power of two below
// it; kernel 4's solve takes any.
#pragma once

#include <math.h>

#include "cr_solve_body.cuh"

#ifdef __CUDACC__
#include <cuda_pipeline_primitives.h>
#endif

namespace mono {

constexpr int kMaxSoc = 32;
constexpr int kPanel = 8;   // the reference's Cholesky panel width
constexpr int kWarp = 32;
constexpr int kTile = 4;    // register tile of the level products (4 x 4)
// shared memory given to the block factors' tiles: 15 float tiles of a
// 48-wide block at the flagship shapes (level 0's 15 odd blocks at
// K=30), 7 double ones
constexpr long long kFactorBytes = 163840;

// Per-phase clock counters (optional): thread 0 reads clock64() after the
// barrier that ends a phase and adds the cycles since the last reading to
// that phase. The initialization (everything before the first iteration)
// counts as one phase. The two slots after the phases hold the block's
// whole run in clock64() cycles and in globaltimer nanoseconds, which
// convert cycles to time. kCrSolve is kernel 4's solve inside the KKT
// solves (cr::solve in raw_solve); kSolves has the rest of them.
enum Phase {
  kInit, kResiduals, kScaling, kAssembly, kBlockFactor, kLevelProducts,
  kSolves, kCrSolve, kConeStep, kRest, kPhases
};
constexpr int kProfSlots = kPhases + 2;

#ifdef __CUDACC__
__device__ __forceinline__ long long wall_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}
#endif

struct Dims {
  int K, w, me, l, S, mc, Wp;
  int soc_off[kMaxSoc];
  int soc_q[kMaxSoc];
  int iters, refine_steps, track_best;
  int part;  // -1 whole solve, -2 initialization only, N >= 0 iterations
  int nfac;  // block factors at once (one warp and one shared tile each)
  double eps_reg, rho, eps_feas, step_frac, warm_kappa;
};

// NaN-propagating min/max, as jnp.minimum / torch.minimum
template <typename T>
__device__ __forceinline__ T jmin(T a, T b) { return (a < b || a != a) ? a : b; }
template <typename T>
__device__ __forceinline__ T jmax(T a, T b) { return (a > b || a != a) ? a : b; }
// the reference's Cholesky pivot floor (scpp_tpu/solver/mono_blocks.py chol8)
template <typename T>
__device__ __forceinline__ T floored(T p) { return jmax(p, T(1e-30)); }

// padded row strides of the staged GT / AT tiles: odd, so that the rows a
// warp reads at one column fall in distinct banks
__host__ __device__ inline int odd_stride(int n) { return n | 1; }

// Element counts of the per-scenario global workspace and of the dynamic
// shared memory, shared by the kernel and the host wrapper. The
// workspace starts with the factor and is a multiple of 4 elements long,
// so that every scenario's factor lies at a 16-byte aligned address, as
// kernel 4's bulk copies of it need.
__host__ __device__ inline long long workspace_elems(int K, int w, int me,
                                                     int mc) {
  const long long Wp = w + me, WW = Wp * Wp;
  const long long nw = (long long)K * w, ne = (long long)K * me,
                  nc = (long long)K * mc;
  const long long n =
      (K - 1) * 3 * WW + WW       // the factor, in cr_pack's layout
      + 2 * K * WW                // the level's diagonal blocks, twice
      + 2 * (K - 1) * w * Wp      // its couplings (first w rows), twice
      + 2 * K * Wp                // right-hand side and solution
      + 20 * nc + 10 * nw + 10 * ne;
  return (n + 3) / 4 * 4;
}

// Row stride of a block factor's shared tile: at least n and 4 (mod 8),
// so that the 8 x 4 lanes of a warp's 2D update hit 32 distinct banks.
__host__ __device__ inline int tile_stride(int n) {
  return n + (12 - n % 8) % 8;
}

// elements of one block factor's shared tile: the block (tile_stride
// per row), a column and a row of it, and a flag per lane
__host__ __device__ inline long long factor_tile_elems(int n) {
  return (long long)n * tile_stride(n) + 2 * n + kWarp;
}

// block factors that run at once with `threads` threads
__host__ __device__ inline int factor_tiles(int w, int me, int threads,
                                            int elem_bytes) {
  const long long fit =
      kFactorBytes / (factor_tile_elems(w + me) * elem_bytes);
  const int warps = (threads + kWarp - 1) / kWarp;
  return (int)(fit < 1 ? 1 : fit < warps ? fit : warps);
}

// the dynamic shared memory in elements of the `elem_bytes`-byte type: the
// region (assembly, block factors or kernel 4's solve with at least one
// ring slot), then a reduction buffer of `threads`
__host__ __device__ inline long long smem_elems(int K, int w, int me, int mc,
                                               int threads, int nfac,
                                               int elem_bytes) {
  const long long Wp = w + me;
  const long long assemble =
      6LL * w * odd_stride(mc) + 4LL * w * odd_stride(me) + 8LL * mc +
      (long long)w * w;
  const long long fac = nfac * factor_tile_elems(w + me);
  const long long solve = cr::smem_elems(K, (int)Wp, elem_bytes);
  long long region = assemble > fac ? assemble : fac;
  region = region > solve ? region : solve;
  return region + threads;
}

// The block's dynamic shared memory. Pointers into it are derived from
// this symbol wherever they are used (never stored in the Solver), so
// that the compiler sees the shared address space and emits shared loads
// and stores (LDS/STS) rather than generic ones. The host build points
// it at the block's buffer.
#ifdef __CUDACC__
extern __shared__ __align__(16) unsigned char mono_smem[];
#else
extern unsigned char* mono_smem;
#endif

// ---- the factor's building blocks ----

// One warp factors one n x n block, as the reference's signed_chol_inv
// (scpp_tpu/solver/mono_blocks.py) does: F (its shared tile, with room
// for factor_tile_elems(n)) gets the block, the signed Cholesky L
// (D = L S L^T, S = +1 on the p primal columns, -1 on the dual ones) in
// 8-column panels with every pivot floored at 1e-30, then L^{-1} in
// place; Lout (row stride n) gets L^{-1} (zero above the diagonal) and
// Lcopy, when given, L. Column j has t_j = max(s_j D_jj, 1e-30) and
// divides the rows of its own panel by sqrt(t_j), the rows below it by
// L_jj = s_j D_jj / sqrt(t_j); without a floored pivot that is the
// ordinary factor. A factor with an entry that is not finite is NaN as a
// whole, as the reference's panel products make it. The block is read
// from its lower triangle. Both halves are right-looking: per column j
// one rank-1 update of the trailing triangle (Cholesky), then per row j
// of L^{-1} one update of the rows below (each entry's terms summed in
// the order of the row-by-row substitution), with the lanes spread over
// the updated entries as an 8 x 4 grid (fewer lanes: a smaller grid).
template <typename T>
__device__ __forceinline__ void warp_block_factor_smem(const T* Dsrc, T* F,
                                                       T* Lout, T* Lcopy,
                                                       int n, int p,
                                                       int lane, int nl) {
  const int ts = tile_stride(n);
  T* __restrict__ Fr = F;
  T* __restrict__ ev = F + (long long)n * ts;   // a column of L
  T* __restrict__ xr = ev + n;                  // a row of L^{-1}
  T* __restrict__ flag = xr + n;
  const int gc = nl < 4 ? nl : 4, gr = nl / gc;
  const int lr = lane / gc, lc = lane % gc;
  for (int r = 0; r < n; ++r)
    for (int cc = lane; cc <= r; cc += nl)
      __pipeline_memcpy_async(Fr + r * ts + cc, Dsrc + r * n + cc, sizeof(T));
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();
  bool bad = false;
  for (int j = 0; j < n; ++j) {
    const T sg = j < p ? T(1) : T(-1);
    const T d = sg * Fr[j * ts + j];
    const T rt = sqrt(floored(d)), ljj = d / rt;
    const int own = (j / kPanel + 1) * kPanel;
    __syncwarp();
    for (int r = j + lane; r < n; r += nl) {
      const T e = sg * Fr[r * ts + j] / (r < own ? rt : ljj);
      Fr[r * ts + j] = e;
      ev[r] = e;
      bad = bad || !isfinite(e);
    }
    __syncwarp();
    // F_rc -= s e_r e_c for j < c <= r
    for (int r = j + 1 + lr; r < n; r += gr) {
      const T er = sg * ev[r];
      T* f = Fr + r * ts;
      int cc = j + 1 + lc;
      for (; cc + gc <= r; cc += 2 * gc) {
        const T f0 = f[cc], f1 = f[cc + gc], e0 = ev[cc], e1 = ev[cc + gc];
        f[cc] = f0 - er * e0;
        f[cc + gc] = f1 - er * e1;
      }
      if (cc <= r) f[cc] -= er * ev[cc];
    }
    __syncwarp();
  }
  flag[lane] = bad ? T(1) : T(0);
  if (Lcopy != nullptr)
    for (int r = 0; r < n; ++r)
      for (int cc = lane; cc < n; cc += nl)
        Lcopy[r * n + cc] = cc > r ? T(0) : Fr[r * ts + cc];
  __syncwarp();
  bool overflow = false;
  for (int i = 0; i < nl; ++i) overflow = overflow || flag[i] != T(0);
  // L^{-1} in place, X_jj = 1 / L_jj, X_rc = -(sum_{c <= t < r} L_rt X_tc)
  // / L_rr: at step j row j is final once divided by L_jj, and its terms
  // go into the rows below (the L_rj column saved first: X_rj takes its
  // slot)
  for (int j = 0; j < n; ++j) {
    const T ljj = Fr[j * ts + j];
    for (int cc = lane; cc <= j; cc += nl) {
      const T x = cc == j ? T(1) / ljj : Fr[j * ts + cc] / ljj;
      if (cc < j) Fr[j * ts + cc] = x;
      xr[cc] = x;
    }
    for (int r = j + 1 + lane; r < n; r += nl) ev[r] = Fr[r * ts + j];
    __syncwarp();
    if (lane == 0) Fr[j * ts + j] = xr[j];
    for (int r = j + 1 + lr; r < n; r += gr) {
      const T lrj = ev[r];
      T* f = Fr + r * ts;
      int cc = lc;
      for (; cc + gc < j; cc += 2 * gc) {
        const T f0 = f[cc], f1 = f[cc + gc], x0 = xr[cc], x1 = xr[cc + gc];
        f[cc] = f0 - lrj * x0;
        f[cc + gc] = f1 - lrj * x1;
      }
      for (; cc < j; cc += gc) f[cc] -= lrj * xr[cc];
      if (cc == j) f[j] = -(lrj * xr[j]);
    }
    __syncwarp();
  }
  for (int r = 0; r < n; ++r)
    for (int cc = lane; cc < n; cc += nl) {
      const T v = overflow ? T(NAN) : cc > r ? T(0) : Fr[r * ts + cc];
      Fr[r * ts + cc] = v;
      Lout[r * n + cc] = v;
    }
  __syncwarp();
}

// The same block factor with the block in registers, for n == kRegN (48,
// the flagship's Wp) and a full warp: lane l < 24 holds rows l and 47 - l
// (l + 1 and 48 - l entries of the lower triangle), so every lane holds
// 49 entries and the steps exchange one column (Cholesky) or one row
// (inverse) by shuffles, with no shared-memory round trip per entry. The
// arithmetic is the shared-memory version's, except that a row of
// L^{-1} is scaled by 1 / L_jj. F gets L^{-1} at its tile stride too.
constexpr int kRegN = 48;

template <typename T>
__device__ __noinline__ void warp_block_factor_reg(const T* Dsrc, T* F,
                                                   T* Lout, T* Lcopy, int p,
                                                   int lane) {
  constexpr int N = kRegN, H = kRegN / 2;
  constexpr unsigned kAll = 0xffffffffu;
  const int ts = tile_stride(N);
  const bool act = lane < H;
  const int ra = lane, rb = N - 1 - lane;   // the lane's two rows
  T A[H], Bv[N];
#pragma unroll
  for (int c = 0; c < H; ++c)
    A[c] = act && c <= ra ? Dsrc[ra * N + c] : T(0);
#pragma unroll
  for (int c = 0; c < N; ++c)
    Bv[c] = act && c <= rb ? Dsrc[rb * N + c] : T(0);
  bool bad = false;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    constexpr int dummy = 0;
    const int ja = j < H ? j : dummy;
    const T sg = j < p ? T(1) : T(-1);
    const T d = sg * __shfl_sync(kAll, j < H ? A[ja] : Bv[j],
                                 j < H ? j : N - 1 - j);
    const T rt = sqrt(floored(d)), ljj = d / rt;
    const int own = (j / kPanel + 1) * kPanel;
    T ea = T(0), eb = T(0);
    if (j < H && act && ra >= j) {
      ea = sg * A[ja] / (ra < own ? rt : ljj);
      A[ja] = ea;
      bad = bad || !isfinite(ea);
    }
    if (act && rb >= j) {
      eb = sg * Bv[j] / (rb < own ? rt : ljj);
      Bv[j] = eb;
      bad = bad || !isfinite(eb);
    }
    const T sa = sg * ea, sb = sg * eb;
#pragma unroll
    for (int c = j + 1; c < N; ++c) {
      const T ec = __shfl_sync(kAll, c < H ? ea : eb, c < H ? c : N - 1 - c);
      if (c < H && act && c <= ra) A[c < H ? c : 0] -= sa * ec;
      if (act && c <= rb) Bv[c] -= sb * ec;
    }
  }
  const bool overflow = __any_sync(kAll, bad) != 0;
  if (Lcopy != nullptr && act) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      Lcopy[ra * N + c] = c <= ra ? A[c < H ? c : 0] : T(0);
      Lcopy[rb * N + c] = c <= rb ? Bv[c] : T(0);
    }
  }
  // L^{-1}: at step j row j is final once scaled by 1 / L_jj, and its
  // terms go into the rows below it
#pragma unroll
  for (int j = 0; j < N; ++j) {
    constexpr int dummy = 0;
    const int ja = j < H ? j : dummy;
    const int owner = j < H ? j : N - 1 - j;
    const T inv = T(1) / __shfl_sync(kAll, j < H ? A[ja] : Bv[j], owner);
    if (j < H && act && ra == j) {
#pragma unroll
      for (int c = 0; c <= j; ++c)
        A[c < H ? c : 0] = c == j ? inv : A[c < H ? c : 0] * inv;
    }
    if (act && rb == j) {
#pragma unroll
      for (int c = 0; c <= j; ++c) Bv[c] = c == j ? inv : Bv[c] * inv;
    }
    const T la = j < H && act && ra > j ? A[ja] : T(0);
    const T lb = act && rb > j ? Bv[j] : T(0);
#pragma unroll
    for (int c = 0; c <= j; ++c) {
      const T xc = __shfl_sync(kAll, j < H ? A[c < H ? c : 0] : Bv[c], owner);
      if (j < H && act && ra > j) {
        if (c < j) A[c < H ? c : 0] -= la * xc;
        else A[ja] = -(la * xc);
      }
      if (act && rb > j) {
        if (c < j) Bv[c] -= lb * xc;
        else Bv[c] = -(lb * xc);
      }
    }
  }
  if (act) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const T va = overflow ? T(NAN) : c <= ra ? A[c < H ? c : 0] : T(0);
      const T vb = overflow ? T(NAN) : c <= rb ? Bv[c] : T(0);
      Lout[ra * N + c] = va;
      Lout[rb * N + c] = vb;
      F[ra * ts + c] = va;
      F[rb * ts + c] = vb;
    }
  }
  __syncwarp();
}

// The block factor: in registers for a float 48 x 48 block and a full
// warp (49 entries a lane fit the registers only in float), else in the
// shared tile. The host build selects alike, so its float instantiation
// runs the register factor and its double one the shared one.
template <typename T>
__device__ __forceinline__ void warp_block_factor(const T* Dsrc, T* F,
                                                  T* Lout, T* Lcopy, int n,
                                                  int p, int lane, int nl) {
  if constexpr (sizeof(T) == 4) {
    if (n == kRegN && nl == kWarp) {
      warp_block_factor_reg(Dsrc, F, Lout, Lcopy, p, lane);
      return;
    }
  }
  warp_block_factor_smem(Dsrc, F, Lout, Lcopy, n, p, lane, nl);
}

// acc[a][b] += sum_{t < n} s_t A[i0 + a, t] B[j0 + b, t] for a kTile x
// kTile tile, with A[i, t] = A0[i ai + t at] (B alike); rows past ni / nj
// read 0. s_t is S's sign: -1 for t >= p (p = n: all +1).
template <typename T>
__device__ __forceinline__ void tile_dot(const T* A0, long long ai,
                                         long long at, const T* B0,
                                         long long bj, long long bt, int i0,
                                         int j0, int ni, int nj, int n,
                                         int p, T (&acc)[kTile][kTile]) {
#pragma unroll 4
  for (int t = 0; t < n; ++t) {
    const T sg = t >= p ? T(-1) : T(1);
    T av[kTile], bw[kTile];
    for (int a = 0; a < kTile; ++a)
      av[a] = i0 + a < ni ? sg * A0[(i0 + a) * ai + t * at] : T(0);
    for (int b = 0; b < kTile; ++b)
      bw[b] = j0 + b < nj ? B0[(j0 + b) * bj + t * bt] : T(0);
    for (int a = 0; a < kTile; ++a)
      for (int b = 0; b < kTile; ++b) acc[a][b] += av[a] * bw[b];
  }
}

// R = L^{-1} O_left and Q = L^{-1} O_rt^T of `cnt` odd blocks m0.. of a
// level of n blocks, whose L^{-1} sit in the factor tiles (tiles, one
// every tstride elements), into the factor's (R, Q) slots (`blocks`, the
// level's first odd block). O holds the level's couplings, w rows each.
// O's last me rows are zero, so R sums over w terms and Q's last me
// columns are zero.
template <typename T>
__device__ __forceinline__ void level_rq(const T* tiles, long long tstride,
                                      const T* O, int n, int m0, int cnt,
                                      T* blocks, int Wp, int w, int tid,
                                      int nt) {
  const long long WW = (long long)Wp * Wp;
  const int tb = (Wp + kTile - 1) / kTile, tw = (w + kTile - 1) / kTile;
  const int per = tb * tb + tb * tw;
  for (int it = tid; it < cnt * per; it += nt) {
    const int q = it / per, rem = it % per, m = m0 + q;
    const T* Li = tiles + q * tstride;
    const int ls = tile_stride(Wp);
    T* Fm = blocks + (long long)m * 3 * WW;
    T acc[kTile][kTile] = {};
    if (rem < tb * tb) {
      const int i0 = rem / tb * kTile, j0 = rem % tb * kTile;
      tile_dot(Li, ls, 1, O + (long long)(2 * m) * w * Wp, 1, Wp, i0, j0,
               Wp, Wp, w, w, acc);
      for (int a = 0; a < kTile && i0 + a < Wp; ++a)
        for (int b = 0; b < kTile && j0 + b < Wp; ++b)
          Fm[WW + (i0 + a) * Wp + j0 + b] = acc[a][b];
    } else {
      const int r2 = rem - tb * tb;
      const int i0 = r2 / tw * kTile, j0 = r2 % tw * kTile;
      if (2 * m + 1 < n - 1)
        tile_dot(Li, ls, 1, O + (long long)(2 * m + 1) * w * Wp, Wp, 1, i0,
                 j0, Wp, w, Wp, Wp, acc);
      for (int a = 0; a < kTile && i0 + a < Wp; ++a) {
        for (int b = 0; b < kTile && j0 + b < w; ++b)
          Fm[2 * WW + (i0 + a) * Wp + j0 + b] = acc[a][b];
        if (j0 + kTile >= w)
          for (int b = w; b < Wp; ++b) Fm[2 * WW + (i0 + a) * Wp + b] = 0;
      }
    }
  }
}

// The even blocks of the next level from a level of n blocks D (and the
// factor's (L^{-1}, R, Q) of its odd blocks): D'_m = D_2m - R_m^T S R_m
// - Q_{m-1}^T S Q_{m-1} (lower triangle: the factors read no more) and
// O'_m = -Q_m^T S R_m (its first w rows; the rest is zero).
template <typename T>
__device__ __forceinline__ void level_schur(const T* D, int n,
                                         const T* blocks, T* Dn, T* On,
                                         int Wp, int w, int tid, int nt) {
  const long long WW = (long long)Wp * Wp;
  const int o = n / 2, ne = n - o;
  const int tb = (Wp + kTile - 1) / kTile, tw = (w + kTile - 1) / kTile;
  const int tri = tb * (tb + 1) / 2, per = tri + tb * tw;
  for (int it = tid; it < ne * per; it += nt) {
    const int m = it / per, rem = it % per;
    T acc[kTile][kTile] = {};
    if (rem < tri) {
      int ti = 0;
      while ((ti + 1) * (ti + 2) / 2 <= rem) ++ti;
      const int i0 = ti * kTile, j0 = (rem - ti * (ti + 1) / 2) * kTile;
      const T* Dm = D + (long long)(2 * m) * WW;
      T* Dnm = Dn + (long long)m * WW;
      for (int a = 0; a < kTile; ++a)
        for (int b = 0; b < kTile; ++b)
          if (i0 + a < Wp && j0 + b < Wp)
            acc[a][b] = Dm[(i0 + a) * Wp + j0 + b];
      if (m < o) {
        const T* R = blocks + ((long long)m * 3 + 1) * WW;
        T sr[kTile][kTile] = {};
        tile_dot(R, 1, Wp, R, 1, Wp, i0, j0, Wp, Wp, Wp, w, sr);
        for (int a = 0; a < kTile; ++a)
          for (int b = 0; b < kTile; ++b) acc[a][b] -= sr[a][b];
      }
      if (m >= 1 && i0 < w && j0 < w) {
        const T* Q = blocks + ((long long)(m - 1) * 3 + 2) * WW;
        T sq[kTile][kTile] = {};
        tile_dot(Q, 1, Wp, Q, 1, Wp, i0, j0, w, w, Wp, w, sq);
        for (int a = 0; a < kTile; ++a)
          for (int b = 0; b < kTile; ++b) acc[a][b] -= sq[a][b];
      }
      for (int a = 0; a < kTile && i0 + a < Wp; ++a)
        for (int b = 0; b < kTile && j0 + b < Wp; ++b)
          Dnm[(i0 + a) * Wp + j0 + b] = acc[a][b];
    } else if (m + 1 < ne) {
      const int r2 = rem - tri;
      const int i0 = r2 / tb * kTile, j0 = r2 % tb * kTile;
      const T* R = blocks + ((long long)m * 3 + 1) * WW;
      const T* Q = blocks + ((long long)m * 3 + 2) * WW;
      tile_dot(Q, 1, Wp, R, 1, Wp, i0, j0, w, Wp, Wp, w, acc);
      T* Onm = On + (long long)m * w * Wp;
      for (int a = 0; a < kTile && i0 + a < w; ++a)
        for (int b = 0; b < kTile && j0 + b < Wp; ++b)
          Onm[(i0 + a) * Wp + j0 + b] = -acc[a][b];
    }
  }
}

template <typename T>
struct Solver {
  const Dims& P;
  int K, w, me, mc, l, S, Wp, U, tid, nt, nfac;
  long long WW;
  // inputs of this scenario
  const T *AT, *GT, *beq, *h, *c, *deq, *dc, *Est;
  // KKT blocks and factor (global): D and O of the level being reduced
  // and of the next, the factor in cr_pack's layout, solve vectors
  T *Dl, *Ol, *Fb, *Froot, *bv, *xv;
  // iterate state and temporaries (global)
  T *x, *y, *s, *z, *bx, *by, *bs, *bz;
  T *rx, *ry, *rz, *rd, *ru, *rdet, *lam, *idd, *idu, *iddet;
  T *dx, *dy, *dz, *ds, *c1, *c2, *w1, *w2, *e1, *e2;
  // kkt_solve scratch (global); gd is G dx of the last solve
  T *u3, *sy, *sz, *r1, *ax, *gx, *gd, *mx, *rr1, *ff2, *cx, *cy;
  // shared: one region that the assembly, the block factors and the
  // solves use in turn, then the reduction buffer (at red_off)
  long long red_off;
  __device__ __forceinline__ T* region() const {
    return reinterpret_cast<T*>(mono_smem);
  }
  __device__ __forceinline__ T* red() const { return region() + red_off; }
  // phase counters (thread 0 only; prof null: nothing recorded)
  long long* prof = nullptr;
  long long pacc[kPhases] = {};
  long long t_last = 0, t0_cycles = 0, t0_ns = 0;
  bool in_init = true;

  __device__ void tick(int phase) {
    if (prof == nullptr || tid != 0) return;
    const long long now = clock64();
    pacc[in_init ? int(kInit) : phase] += now - t_last;
    t_last = now;
  }

  __device__ Solver(const Dims& dims, T* work, const T* AT_,
                    const T* GT_, const T* beq_, const T* h_, const T* c_,
                    const T* deq_, const T* dc_, const T* Est_)
      : P(dims) {
    K = P.K; w = P.w; me = P.me; mc = P.mc; l = P.l; S = P.S; Wp = P.Wp;
    U = l + S;
    WW = (long long)Wp * Wp;
    tid = threadIdx.x;
    nt = blockDim.x;
    nfac = P.nfac;
    AT = AT_; GT = GT_; beq = beq_; h = h_; c = c_; deq = deq_; dc = dc_;
    Est = Est_;
    const int nw = K * w, ne = K * me, nc = K * mc;
    T* p = work;
    Fb = p; p += (K - 1) * 3 * WW;
    Froot = p; p += WW;
    Dl = p; p += 2 * K * WW;
    Ol = p; p += 2LL * (K - 1) * w * Wp;
    bv = p; p += (long long)K * Wp;
    xv = p; p += (long long)K * Wp;
    T** cvecs[] = {&s, &z, &bs, &bz, &rz, &rd, &ru, &rdet, &lam, &idd, &idu,
                   &iddet, &dz, &ds, &c1, &c2, &u3, &sz, &gx, &gd};
    for (T** v : cvecs) { *v = p; p += nc; }
    T** wvecs[] = {&x, &bx, &rx, &dx, &w1, &w2, &r1, &mx, &rr1, &cx};
    for (T** v : wvecs) { *v = p; p += nw; }
    T** evecs[] = {&y, &by, &ry, &dy, &e1, &e2, &sy, &ax, &ff2, &cy};
    for (T** v : evecs) { *v = p; p += ne; }
    red_off = smem_elems(K, w, me, mc, nt, nfac, sizeof(T)) - nt;
  }

  __device__ __forceinline__ void sync() { __syncthreads(); }

  // ---- block reductions: by shuffles within each group of G =
  // min(32, blockDim.x) lanes (a power of two dividing blockDim.x), then
  // over the groups' results in a fixed order by every thread ----

  template <typename Op>
  __device__ T reduce(T v, Op op) {
    const int G = nt < kWarp ? nt : kWarp;
    for (int o = G / 2; o > 0; o >>= 1)
      v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
    T* rb = red();
    if (tid % G == 0) rb[tid / G] = v;
    sync();
    T r = rb[0];
    for (int i = 1; i < nt / G; ++i) r = op(r, rb[i]);
    sync();
    return r;
  }
  struct Add { __device__ T operator()(T a, T b) const { return a + b; } };
  struct Min { __device__ T operator()(T a, T b) const { return jmin(a, b); } };
  struct Max { __device__ T operator()(T a, T b) const { return jmax(a, b); } };
  __device__ T sum(T v) { return reduce(v, Add()); }

  __device__ T dot(const T* a, const T* b, int n) {
    T acc = 0;
    for (int i = tid; i < n; i += nt) acc += a[i] * b[i];
    return sum(acc);
  }
  __device__ T norm2_div(const T* a, const T* d, int n) {
    T acc = 0;
    for (int i = tid; i < n; i += nt) {
      const T v = a[i] / d[i];
      acc += v * v;
    }
    return sum(acc);
  }
  __device__ void copy(const T* a, T* out, int n) {
    for (int i = tid; i < n; i += nt) out[i] = a[i];
    sync();
  }

  // ---- staged matvecs ----

  __device__ __forceinline__ T xcat(const T* v, int k, int cc) const {
    if (cc < w) return v[k * w + cc];
    return k + 1 < K ? v[(k + 1) * w + cc - w] : T(0);
  }
  // out (K, m) = blocks^T [x_k | x_{k+1}] for AT (m = me) or GT (m = mc)
  __device__ void rows_mv(const T* M, int m, const T* v, T* out) {
    for (int i = tid; i < K * m; i += nt) {
      const int k = i / m, r = i % m;
      const T* a = M + (long long)k * 2 * w * m + r;
      T acc = 0;
#pragma unroll 4
      for (int cc = 0; cc < 2 * w; ++cc) acc += a[cc * m] * xcat(v, k, cc);
      out[i] = acc;
    }
    sync();
  }
  __device__ void A_mv(const T* v, T* out) { rows_mv(AT, me, v, out); }
  __device__ void G_mv(const T* v, T* out) { rows_mv(GT, mc, v, out); }
  __device__ T col_dot(int k, int cc, const T* yv, const T* zv) const {
    const T* a = AT + ((long long)k * 2 * w + cc) * me;
    const T* g = GT + ((long long)k * 2 * w + cc) * mc;
    T s1 = 0, s2 = 0;
#pragma unroll 4
    for (int m = 0; m < me; ++m) s1 += a[m] * yv[k * me + m];
#pragma unroll 4
    for (int j = 0; j < mc; ++j) s2 += g[j] * zv[k * mc + j];
    return s1 + s2;
  }
  // out (K, w) = A^T y + G^T z folded back onto the stage variables
  __device__ void AG_rmv(const T* yv, const T* zv, T* out) {
    for (int i = tid; i < K * w; i += nt) {
      const int k = i / w, j = i % w;
      T acc = col_dot(k, j, yv, zv);
      if (k > 0) acc += col_dot(k - 1, w + j, yv, zv);
      out[i] = acc;
    }
    sync();
  }

  // ---- cones: one work item per (stage, cone); a nonneg slot is a cone ----

  __device__ __forceinline__ void unit(int u, int& off, int& q) const {
    if (u < l) { off = u; q = 1; }
    else { off = P.soc_off[u - l]; q = P.soc_q[u - l]; }
  }
  static __device__ __forceinline__ T Jsgn(int j) { return j == 0 ? T(1) : T(-1); }
  __device__ __forceinline__ bool is_head(int slot) const {
    for (int i = 0; i < S; ++i)
      if (P.soc_off[i] == slot) return true;
    return false;
  }
  __device__ __forceinline__ T e_slot(int slot) const {
    return (slot < l || is_head(slot)) ? T(1) : T(0);
  }

  // W^{-1} v on one cone of a scaling rep; out may alias v
  __device__ __forceinline__ void winv_cone(bool lin, int q, const T* d,
                                            const T* uu, const T* det,
                                            const T* v, T* out) const {
    if (lin) { out[0] = v[0] / d[0]; return; }
    const T dt = det[0];
    T sacc = 0;
    for (int j = 0; j < q; ++j) sacc += (Jsgn(j) * uu[j] / dt) * v[j];
    for (int j = 0; j < q; ++j) {
      const T ui = Jsgn(j) * uu[j] / dt;
      out[j] = T(2) * ui * sacc - (Jsgn(j) * v[j]) / dt;
    }
  }
  // W^{-1} v, or W^{-2} v (W^{-1} twice, cone by cone) with `twice`
  __device__ void apply_Winv(const T* d, const T* uu, const T* det,
                             const T* v, T* out, bool twice = false) {
    for (int i = tid; i < K * U; i += nt) {
      const int k = i / U, u = i % U;
      int off, q;
      unit(u, off, q);
      const int b = k * mc + off;
      winv_cone(u < l, q, d + b, uu + b, det + b, v + b, out + b);
      if (twice)
        winv_cone(u < l, q, d + b, uu + b, det + b, out + b, out + b);
    }
    sync();
  }
  __device__ void apply_W(const T* d, const T* uu, const T* det, const T* v,
                          T* out) {
    for (int i = tid; i < K * U; i += nt) {
      const int k = i / U, u = i % U;
      int off, q;
      unit(u, off, q);
      const int b = k * mc + off;
      if (u < l) { out[b] = d[b] * v[b]; continue; }
      T su = 0;
      for (int j = 0; j < q; ++j) su += uu[b + j] * v[b + j];
      const T dt = det[b];
      for (int j = 0; j < q; ++j)
        out[b + j] = T(2) * uu[b + j] * su - dt * (Jsgn(j) * v[b + j]);
    }
    sync();
  }
  // Jordan product; out may alias u or v
  __device__ void cone_mul(const T* a, const T* bv, T* out) {
    for (int i = tid; i < K * U; i += nt) {
      const int k = i / U, u = i % U;
      int off, q;
      unit(u, off, q);
      const int b = k * mc + off;
      if (u < l) { out[b] = a[b] * bv[b]; continue; }
      T sacc = 0;
      for (int j = 0; j < q; ++j) sacc += a[b + j] * bv[b + j];
      const T a0 = a[b], b0 = bv[b];
      for (int j = 1; j < q; ++j) out[b + j] = a0 * bv[b + j] + b0 * a[b + j];
      out[b] = sacc;
    }
    sync();
  }
  __device__ void cone_inv(const T* a, T* out) {
    for (int i = tid; i < K * U; i += nt) {
      const int k = i / U, u = i % U;
      int off, q;
      unit(u, off, q);
      const int b = k * mc + off;
      if (u < l) { out[b] = T(1) / a[b]; continue; }
      T det = 0;
      for (int j = 0; j < q; ++j) det += Jsgn(j) * a[b + j] * a[b + j];
      for (int j = 0; j < q; ++j) out[b + j] = Jsgn(j) * a[b + j] / det;
    }
    sync();
  }
  // max over cones of the interiority defect (-u on nonneg slots,
  // ||u_tail|| - u_0 on SOCs)
  __device__ T min_shift(const T* a) {
    T m = -INFINITY;
    for (int i = tid; i < K * U; i += nt) {
      const int k = i / U, u = i % U;
      int off, q;
      unit(u, off, q);
      const int b = k * mc + off;
      T val;
      if (u < l) {
        val = -a[b];
      } else {
        T t2 = 0;
        for (int j = 1; j < q; ++j) t2 += a[b + j] * a[b + j];
        val = sqrt(jmax(t2, T(0))) - a[b];
      }
      m = jmax(m, val);
    }
    return reduce(m, Max());
  }
  // largest a with a + alpha da in the cone (capped at 1e20)
  __device__ T max_step(const T* a, const T* da) {
    const T big = T(1e20);
    T m = big;
    for (int i = tid; i < K * U; i += nt) {
      const int k = i / U, u = i % U;
      int off, q;
      unit(u, off, q);
      const int b = k * mc + off;
      T val;
      if (u < l) {
        val = da[b] < 0 ? -a[b] / da[b] : big;
      } else {
        T a2 = 0, b2 = 0, c2 = 0;
        for (int j = 0; j < q; ++j) {
          const T J = Jsgn(j);
          a2 += J * da[b + j] * da[b + j];
          b2 += J * a[b + j] * da[b + j];
          c2 += J * a[b + j] * a[b + j];
        }
        const T disc = b2 * b2 - a2 * c2;
        const T sq = sqrt(jmax(disc, T(0)));
        T a_soc;
        if (a2 < T(-1e-30)) {
          a_soc = (b2 + sq) / jmax(-a2, T(1e-30));
        } else if (a2 > T(1e-30)) {
          a_soc = (disc > 0 && b2 < 0) ? c2 / jmax(-b2 + sq, T(1e-30)) : big;
        } else {
          a_soc = b2 < 0 ? -c2 / (T(2) * b2) : big;
        }
        const T head_cap = da[b] < 0 ? -a[b] / da[b] : big;
        val = jmin(a_soc, head_cap);
      }
      m = jmin(m, val);
    }
    return jmin(reduce(m, Min()), big);
  }
  // NT scaling rep (d on nonneg slots; u, detu on SOC slots) and lambda
  __device__ void nt_scaling(const T* sv, const T* zv) {
    for (int i = tid; i < K * U; i += nt) {
      const int k = i / U, u = i % U;
      int off, q;
      unit(u, off, q);
      const int b = k * mc + off;
      if (u < l) {
        const T sz = jmax(sv[b] * zv[b], T(0));
        rd[b] = sqrt(sz) / zv[b];
        lam[b] = sqrt(sz);
        continue;
      }
      T ds_ = 0, dz_ = 0;
      for (int j = 0; j < q; ++j) {
        ds_ += Jsgn(j) * sv[b + j] * sv[b + j];
        dz_ += Jsgn(j) * zv[b + j] * zv[b + j];
      }
      const T dets = jmax(ds_, T(1e-30)), detz = jmax(dz_, T(1e-30));
      const T rs = sqrt(dets), rzz = sqrt(detz);
      T szdot = 0;
      for (int j = 0; j < q; ++j) szdot += (sv[b + j] / rs) * (zv[b + j] / rzz);
      const T gamma = sqrt(jmax((T(1) + szdot) / T(2), T(1e-30)));
      const T eta = pow(dets / detz, T(0.25));
      T detw = 0;
      for (int j = 0; j < q; ++j) {
        const T wv = eta * ((sv[b + j] / rs + Jsgn(j) * (zv[b + j] / rzz)) /
                            (T(2) * gamma));
        detw += Jsgn(j) * wv * wv;
      }
      const T sqd = sqrt(jmax(detw, T(1e-30)));
      const T wv0 = eta * ((sv[b] / rs + zv[b] / rzz) / (T(2) * gamma));
      const T denom = sqrt(jmax(T(2) * (wv0 + sqd), T(1e-30)));
      T uz = 0;
      for (int j = 0; j < q; ++j) {
        const T wv = eta * ((sv[b + j] / rs + Jsgn(j) * (zv[b + j] / rzz)) /
                            (T(2) * gamma));
        const T uj = (wv + (j == 0 ? sqd : T(0))) / denom;
        ru[b + j] = uj;
        rdet[b + j] = sqd;
        uz += uj * zv[b + j];
      }
      for (int j = 0; j < q; ++j)
        lam[b + j] = T(2) * ru[b + j] * uz - sqd * (Jsgn(j) * zv[b + j]);
    }
    sync();
  }

  // ---- KKT: every stage assembled at once, then cyclic reduction ----
  //
  // Stage block D_k (Wp x Wp) = [[eps I + Hxx_k + Hnn_{k-1}, Axy_k],
  // [Axy_k^T, -delta I]] with Gam = GwT GwT^T + rho AT AT^T, coupling
  // O_k = M[k+1, k] = [[Hxn_k, AT_k[w:, :]], [0, 0]]: only its first w
  // rows are stored. The blocks do not depend on the factor, so all K are
  // assembled before it, with stage k+1's GT and AT tiles copied in
  // (cp.async) while stage k's products run.

  // one stage's GT and AT tiles and its cone scaling (d, u, det: 3 mc)
  // in shared memory, buffer `buf`
  __device__ long long stage_elems() const {
    return 2LL * w * (odd_stride(mc) + odd_stride(me)) + 3LL * mc;
  }
  __device__ T* gtile(int buf) const {
    return region() + buf * stage_elems();
  }
  __device__ T* atile(int buf) const {
    return gtile(buf) + 2LL * w * odd_stride(mc);
  }
  __device__ T* stile(int buf) const {
    return atile(buf) + 2LL * w * odd_stride(me);
  }
  __device__ void stage_copy(int k, int buf, const T* d, const T* uu,
                             const T* det) {
    const int gs = odd_stride(mc), as = odd_stride(me);
    const int warp = tid / kWarp, lane = tid % kWarp;
    const int nwarps = (nt + kWarp - 1) / kWarp;
    const int nl = nt - warp * kWarp < kWarp ? nt - warp * kWarp : kWarp;
    const T* GTk = GT + (long long)k * 2 * w * mc;
    const T* ATk = AT + (long long)k * 2 * w * me;
    T* g = gtile(buf);
    T* a = atile(buf);
    T* sc = stile(buf);
    for (int r = warp; r < 2 * w; r += nwarps) {
      for (int cc = lane; cc < mc; cc += nl)
        __pipeline_memcpy_async(g + r * gs + cc, GTk + r * mc + cc,
                                sizeof(T));
      for (int cc = lane; cc < me; cc += nl)
        __pipeline_memcpy_async(a + r * as + cc, ATk + r * me + cc,
                                sizeof(T));
    }
    for (int i = tid; i < mc; i += nt) {
      __pipeline_memcpy_async(sc + i, d + k * mc + i, sizeof(T));
      __pipeline_memcpy_async(sc + mc + i, uu + k * mc + i, sizeof(T));
      __pipeline_memcpy_async(sc + 2 * mc + i, det + k * mc + i, sizeof(T));
    }
    __pipeline_commit();
  }

  __device__ void assemble(const T* d, const T* uu, const T* det) {
    const T eps = T(P.eps_reg), rho = T(P.rho);
    const int gs = odd_stride(mc), as = odd_stride(me), hw = (w + 1) / 2;
    T* hnn = region() + 2 * stage_elems();  // Hnn of the previous stage
    T* gw = hnn + w * w;                   // W^{-1} G_k^T
    T* cone = gw + 2 * w * gs;             // per slot: its cone's head, size
    T* D0 = Dl;
    T* O0 = Ol;
    for (int j = tid; j < mc; j += nt) {
      int head = -1, q = 1;
      for (int c = 0; c < S; ++c)
        if (j >= P.soc_off[c] && j < P.soc_off[c] + P.soc_q[c]) {
          head = P.soc_off[c];
          q = P.soc_q[c];
        }
      cone[j] = T(head);
      cone[mc + j] = T(q);
    }
    stage_copy(0, 0, d, uu, det);
    for (int k = 0; k < K; ++k) {
      const int buf = k & 1;
      if (k + 1 < K) {
        stage_copy(k + 1, buf ^ 1, d, uu, det);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      sync();
      const T* g = gtile(buf);
      const T* a = atile(buf);
      T* sc = stile(buf);
      // the stage's scaling per slot: 1 / d (nonneg), J u / det and
      // J / det (SOC), so that W^{-1} v needs no division
      for (int j = tid; j < mc; j += nt) {
        if (cone[j] < T(0)) {
          sc[j] = T(1) / sc[j];
        } else {
          const T J = cone[j] == T(j) ? T(1) : T(-1), dt = sc[2 * mc + j];
          sc[mc + j] = J * sc[mc + j] / dt;
          sc[2 * mc + j] = J / dt;
        }
      }
      sync();
      // rows of W^{-1} G_k^T (the scaling applied along the cone axis),
      // one slot of one row per work item
      for (int i = tid; i < 2 * w * mc; i += nt) {
        const int r = i / mc, j = i % mc;
        const T* gr = g + r * gs;
        const int head = int(cone[j]);
        T o;
        if (head < 0) {
          o = gr[j] * sc[j];
        } else {
          const int q = int(cone[mc + j]);
          T sacc = 0;
          for (int t = head; t < head + q; ++t) sacc += sc[mc + t] * gr[t];
          o = T(2) * sc[mc + j] * sacc - sc[2 * mc + j] * gr[j];
        }
        gw[r * gs + j] = o;
      }
      sync();
      // Gram blocks Hxx, Hnn, Hxn at (ra, cb) and (ra, cb + hw): one row
      // and two columns of each per work item
      T* Dk = D0 + k * WW;
      T* Ok = O0 + (long long)k * w * Wp;
      for (int i = tid; i < w * hw; i += nt) {
        const int ra = i / hw, cb = i % hw;
        const bool two = cb + hw < w;
        const int cb2 = two ? cb + hw : cb;
        const T* rx_ = gw + ra * gs;
        const T* rn_ = gw + (w + ra) * gs;
        const T* c0 = gw + cb * gs;
        const T* c1_ = gw + cb2 * gs;
        const T* n0 = gw + (w + cb) * gs;
        const T* n1 = gw + (w + cb2) * gs;
        T gxx[2] = {0, 0}, gn[2] = {0, 0}, gxn[2] = {0, 0};
#pragma unroll 4
        for (int j = 0; j < mc; ++j) {
          const T vx = rx_[j], vn = rn_[j], u0 = c0[j], u1 = c1_[j];
          gxx[0] += vx * u0; gxx[1] += vx * u1;
          gn[0] += vn * n0[j]; gn[1] += vn * n1[j];
          gxn[0] += vn * u0; gxn[1] += vn * u1;
        }
        const T* ax_ = a + ra * as;
        const T* an_ = a + (w + ra) * as;
        const T* e0 = a + cb * as;
        const T* e1_ = a + cb2 * as;
        const T* f0 = a + (w + cb) * as;
        const T* f1_ = a + (w + cb2) * as;
        T ax2[2] = {0, 0}, an2[2] = {0, 0}, axn[2] = {0, 0};
#pragma unroll 4
        for (int m = 0; m < me; ++m) {
          const T vx = ax_[m], vn = an_[m], u0 = e0[m], u1 = e1_[m];
          ax2[0] += vx * u0; ax2[1] += vx * u1;
          an2[0] += vn * f0[m]; an2[1] += vn * f1_[m];
          axn[0] += vn * u0; axn[1] += vn * u1;
        }
        for (int t = 0; t < (two ? 2 : 1); ++t) {
          const int bb = t ? cb2 : cb;
          T dv = (ra == bb ? eps : T(0)) + (gxx[t] + rho * ax2[t]);
          if (k > 0) dv += hnn[ra * w + bb];
          Dk[ra * Wp + bb] = dv;
          hnn[ra * w + bb] = gn[t] + rho * an2[t];
          if (k + 1 < K) Ok[ra * Wp + bb] = gxn[t] + rho * axn[t];
        }
      }
      // the equality blocks of D_k and of O_k's first w rows
      for (int i = tid; i < Wp * Wp; i += nt) {
        const int r = i / Wp, cc = i % Wp;
        if (r < w && cc < w) continue;
        T v;
        if (r < w) v = a[r * as + cc - w];
        else if (cc < w) v = a[cc * as + r - w];
        else v = r == cc ? -eps : T(0);
        Dk[i] = v;
      }
      if (k + 1 < K)
        for (int i = tid; i < w * me; i += nt)
          Ok[(i / me) * Wp + w + i % me] = a[(w + i / me) * as + i % me];
      sync();
    }
    tick(kAssembly);
  }

  // the cyclic-reduction factor of the assembled blocks, in the
  // reference's order (scpp_tpu/solver/mono_blocks.py:mono_cr_factor):
  // per level, the odd blocks' factors (one warp each, nfac at a time),
  // their R and Q, then the next level's blocks; the root last
  __device__ void cr_factor() {
    const int warp = tid / kWarp, lane = tid % kWarp;
    const int nl = nt - warp * kWarp < kWarp ? nt - warp * kWarp : kWarp;
    const long long tstride = factor_tile_elems(Wp);
    T *D = Dl, *O = Ol;
    T* Dn = Dl + K * WW;
    T* On = Ol + (long long)(K - 1) * w * Wp;
    T* blocks = Fb;
    for (int n = K; n > 1; n -= n / 2) {
      const int o = n / 2;
      for (int m0 = 0; m0 < o; m0 += nfac) {
        const int cnt = o - m0 < nfac ? o - m0 : nfac;
        if (warp < cnt)
          warp_block_factor(D + (long long)(2 * (m0 + warp) + 1) * WW,
                            region() + warp * tstride,
                            blocks + (long long)(m0 + warp) * 3 * WW,
                            (T*)nullptr, Wp, w, lane, nl);
        sync();
        tick(kBlockFactor);
        level_rq(region(), tstride, O, n, m0, cnt, blocks, Wp, w, tid, nt);
        sync();
        tick(kLevelProducts);
      }
      level_schur(D, n, blocks, Dn, On, Wp, w, tid, nt);
      sync();
      tick(kLevelProducts);
      T* t = D; D = Dn; Dn = t;
      t = O; O = On; On = t;
      blocks += (long long)o * 3 * WW;
    }
    if (warp == 0)
      warp_block_factor(D, region(), Froot, (T*)nullptr, Wp, w, lane, nl);
    sync();
    tick(kBlockFactor);
  }

  __device__ void factor(const T* d, const T* uu, const T* det) {
    assemble(d, uu, det);
    cr_factor();
  }

  // solve M [ox; oy] = [rx_; ry_] with the stored factor: kernel 4's
  // cyclic-reduction solve (cr_solve_body.cuh) on the same layout, its
  // ring of factor slots in the shared region (red_off elements)
  __device__ void raw_solve(const T* rxv, const T* ryv, T* ox, T* oy) {
    for (int i = tid; i < K * Wp; i += nt) {
      const int k = i / Wp, j = i % Wp;
      bv[i] = j < w ? rxv[k * w + j] : ryv[k * me + j - w];
    }
    sync();
    tick(kSolves);
    cr::solve<T>(K, Wp, w, Fb, Froot, bv, xv, region(),
                 red_off * (long long)sizeof(T), true);
    sync();
    tick(kCrSolve);
    for (int i = tid; i < K * Wp; i += nt) {
      const int k = i / Wp, j = i % Wp;
      if (j < w) ox[k * w + j] = xv[i];
      else oy[k * me + j - w] = xv[i];
    }
    sync();
  }

  // Newton direction for right-hand sides (f1, f2, rzWd) under a rep
  __device__ void kkt_solve(const T* d, const T* uu, const T* det,
                            const T* f1, const T* f2, const T* rzWd,
                            int refine, T* odx, T* ody, T* odz) {
    const int nw = K * w, ne = K * me, nc = K * mc;
    const T rho = T(P.rho);
    apply_Winv(d, uu, det, rzWd, u3, true);
    for (int i = tid; i < ne; i += nt) sy[i] = rho * f2[i];
    for (int i = tid; i < nc; i += nt) sz[i] = -u3[i];
    sync();
    AG_rmv(sy, sz, r1);
    for (int i = tid; i < nw; i += nt) r1[i] = f1[i] + r1[i];
    sync();
    raw_solve(r1, f2, odx, ody);
    for (int it = 0; it < refine; ++it) {
      A_mv(odx, ax);
      G_mv(odx, gx);
      apply_Winv(d, uu, det, gx, gx, true);
      for (int i = tid; i < ne; i += nt) sy[i] = rho * ax[i] + ody[i];
      sync();
      AG_rmv(sy, gx, mx);
      for (int i = tid; i < nw; i += nt) rr1[i] = r1[i] - mx[i];
      for (int i = tid; i < ne; i += nt) ff2[i] = f2[i] - ax[i];
      sync();
      raw_solve(rr1, ff2, cx, cy);
      for (int i = tid; i < nw; i += nt) odx[i] += cx[i];
      for (int i = tid; i < ne; i += nt) ody[i] += cy[i];
      sync();
    }
    G_mv(odx, gd);
    apply_Winv(d, uu, det, gd, gx, true);
    for (int i = tid; i < nc; i += nt) odz[i] = gx[i] + u3[i];
    sync();
    tick(kSolves);
  }

  // residuals rx, ry, rz of (xv, yv, sv, zv); returns the score and sets
  // gap / pres / dres / relgap
  T gap, pres, dres, relgap;
  __device__ T residuals(const T* xv, const T* yv, const T* sv, const T* zv,
                         const T* scal) {
    const int nw = K * w, ne = K * me, nc = K * mc;
    AG_rmv(yv, zv, rx);
    A_mv(xv, ry);
    G_mv(xv, rz);
    for (int i = tid; i < nw; i += nt) rx[i] = c[i] + rx[i];
    for (int i = tid; i < ne; i += nt) ry[i] = ry[i] - beq[i];
    for (int i = tid; i < nc; i += nt) rz[i] = rz[i] + sv[i] - h[i];
    sync();
    gap = dot(sv, zv, nc);
    pres = sqrt(norm2_div(ry, deq, ne) + norm2_div(rz, dc, nc)) * scal[0];
    dres = sqrt(norm2_div(rx, Est, nw)) * scal[1];
    const T obj = dot(c, xv, nw);
    const T by_ = dot(beq, yv, ne) + dot(h, zv, nc);
    const T cb = scal[2];
    relgap = cb * fabs(gap) / (T(1) + cb * (fabs(obj) + fabs(by_)));
    T score = jmax(jmax(pres, dres), relgap);
    return isfinite(score) ? score : T(INFINITY);
  }

  __device__ bool all_finite(const T* a, T alpha, const T* da, int n) {
    T bad = 0;
    for (int i = tid; i < n; i += nt)
      if (!isfinite(a[i] + alpha * da[i])) bad = 1;
    return reduce(bad, Max()) == 0;
  }

  // the whole solve; returns the iteration count and writes the outputs
  __device__ void run(const T* scal, const T* wx, const T* wy, const T* wz,
                      T* ox, T* oy, T* os, T* oz, T* odiag,
                      long long* prof_ = nullptr) {
    prof = prof_;
    if (prof != nullptr && tid == 0) {
      t_last = t0_cycles = clock64();
      t0_ns = wall_ns();
    }
    const int nw = K * w, ne = K * me, nc = K * mc;
    const bool warm = scal[3] > T(0.5);
    const T kappa = T(P.warm_kappa);
    for (int i = tid; i < nc; i += nt) {
      idd[i] = 1;
      iddet[i] = 1;
      const int slot = i % mc;
      idu[i] = (slot >= l && is_head(slot)) ? T(1) : T(0);
    }
    sync();

    // ---- initialization (cold: two solves with the identity scaling) ----
    if (!warm) {
      factor(idd, idu, iddet);
      for (int i = tid; i < nw; i += nt) w1[i] = 0;
      for (int i = tid; i < nc; i += nt) c1[i] = -h[i];
      sync();
      kkt_solve(idd, idu, iddet, w1, beq, c1, 0, x, e1, c2);
    } else {
      copy(wx, x, nw);
    }
    G_mv(x, c1);
    for (int i = tid; i < nc; i += nt) s[i] = h[i] - c1[i];
    sync();
    {
      const T t_p = min_shift(s);
      T shift = t_p < T(-1e-8) ? T(0) : t_p + T(1);
      if (warm) shift = jmax(t_p + kappa, T(0));
      for (int i = tid; i < nc; i += nt) s[i] += shift * e_slot(i % mc);
      sync();
    }
    if (!warm) {
      for (int i = tid; i < nw; i += nt) w1[i] = -c[i];
      for (int i = tid; i < ne; i += nt) e1[i] = 0;
      for (int i = tid; i < nc; i += nt) c1[i] = 0;
      sync();
      kkt_solve(idd, idu, iddet, w1, e1, c1, 0, w2, y, z);
    } else {
      copy(wy, y, ne);
      copy(wz, z, nc);
    }
    {
      const T t_d = min_shift(z);
      T shift = t_d < T(-1e-8) ? T(0) : t_d + T(1);
      if (warm) shift = jmax(t_d + kappa, T(0));
      for (int i = tid; i < nc; i += nt) z[i] += shift * e_slot(i % mc);
      sync();
    }
    if (P.part == -2) {
      copy(x, ox, nw);
      copy(y, oy, ne);
      copy(s, os, nc);
      copy(z, oz, nc);
      if (tid == 0) odiag[0] = odiag[1] = odiag[2] = odiag[3] = 0;
      tick(kInit);
      write_prof();
      return;
    }
    tick(kInit);
    in_init = false;

    const bool track = P.track_best != 0;
    T bscore = T(INFINITY);
    const T nu_deg = T(K * (l + S) > 1 ? K * (l + S) : 1);
    const T eps_feas = T(P.eps_feas);
    const int max_it = P.part >= 0 ? P.part : P.iters;
    int it = 0;
    bool done = false;
    while (it < max_it && !done) {
      const T score = residuals(x, y, s, z, scal);
      const T mu = gap / nu_deg;
      tick(kResiduals);
      nt_scaling(s, z);
      tick(kScaling);
      factor(rd, ru, rdet);
      // predictor (affine) direction
      for (int i = tid; i < nw; i += nt) w1[i] = -rx[i];
      for (int i = tid; i < ne; i += nt) e1[i] = -ry[i];
      for (int i = tid; i < nc; i += nt) c1[i] = rz[i] - s[i];
      sync();
      kkt_solve(rd, ru, rdet, w1, e1, c1, P.refine_steps, dx, dy, dz);
      for (int i = tid; i < nc; i += nt) ds[i] = -gd[i] - rz[i];
      sync();
      const T a_aff = jmin(max_step(s, ds), max_step(z, dz));
      const T alpha_aff = jmin(T(1), a_aff);
      T gacc = 0;
      for (int i = tid; i < nc; i += nt)
        gacc += (s[i] + alpha_aff * ds[i]) * (z[i] + alpha_aff * dz[i]);
      const T gap_aff = sum(gacc);
      T ratio = jmax(gap_aff, T(0)) / jmax(gap, T(1e-30));
      T sigma = jmin(jmax(ratio * ratio * ratio, T(0)), T(1));
      if (!isfinite(sigma)) sigma = 1;
      // corrector rhs: W (lam^{-1} o (-lam o lam - corr + sigma mu e))
      apply_Winv(rd, ru, rdet, ds, c1);
      apply_W(rd, ru, rdet, dz, c2);
      cone_mul(c1, c2, c1);
      for (int i = tid; i < nc; i += nt)
        if (!isfinite(c1[i])) c1[i] = 0;
      sync();
      cone_mul(lam, lam, c2);
      for (int i = tid; i < nc; i += nt)
        c2[i] = -c2[i] - c1[i] + (sigma * mu) * e_slot(i % mc);
      sync();
      cone_inv(lam, c1);
      cone_mul(c1, c2, c2);
      apply_W(rd, ru, rdet, c2, c2);
      for (int i = tid; i < nc; i += nt) c1[i] = rz[i] + c2[i];
      sync();
      tick(kConeStep);
      kkt_solve(rd, ru, rdet, w1, e1, c1, P.refine_steps, dx, dy, dz);
      for (int i = tid; i < nc; i += nt) ds[i] = -gd[i] - rz[i];
      sync();
      const T a_sz = jmin(max_step(s, ds), max_step(z, dz));
      const T alpha = jmin(T(1), T(P.step_frac) * a_sz);
      tick(kConeStep);
      const bool conv = (pres < eps_feas) && (dres < eps_feas) &&
                        (relgap < eps_feas);
      if (track) {
        if (score < bscore) {
          copy(x, bx, nw);
          copy(y, by, ne);
          copy(s, bs, nc);
          copy(z, bz, nc);
        }
        bscore = jmin(score, bscore);
      }
      const bool finite = all_finite(x, alpha, dx, nw) &&
                          all_finite(s, alpha, ds, nc) &&
                          all_finite(z, alpha, dz, nc);
      done = conv || !finite;
      if (finite) {
        for (int i = tid; i < nw; i += nt) x[i] += alpha * dx[i];
        for (int i = tid; i < ne; i += nt) y[i] += alpha * dy[i];
        for (int i = tid; i < nc; i += nt) {
          s[i] += alpha * ds[i];
          z[i] += alpha * dz[i];
        }
        sync();
      }
      ++it;
      tick(kRest);
    }

    // score the final stepped iterate
    const T fscore = residuals(x, y, s, z, scal);
    const bool take_final = !track || fscore < bscore;
    copy(take_final ? x : bx, ox, nw);
    copy(take_final ? y : by, oy, ne);
    copy(take_final ? s : bs, os, nc);
    copy(take_final ? z : bz, oz, nc);
    if (tid == 0) {
      odiag[0] = jmin(fscore, bscore);
      odiag[1] = T(it);
      odiag[2] = 0;
      odiag[3] = 0;
    }
    sync();
    tick(kRest);
    write_prof();
  }

  __device__ void write_prof() {
    if (prof == nullptr || tid != 0) return;
    for (int i = 0; i < kPhases; ++i) prof[i] = pacc[i];
    prof[kPhases] = clock64() - t0_cycles;
    prof[kPhases + 1] = wall_ns() - t0_ns;
  }
};

}  // namespace mono
