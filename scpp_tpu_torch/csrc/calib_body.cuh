// Device bodies of the calibration probes (csrc/calib.cu): each function
// of scpp_tpu_torch/diag/calib.py, looped `iters` dependent steps inside
// one launch. The plain versions are the `_<name>_plain` functions there.
//
// A `*_block` function is the work of one thread block on one matrix (or
// one tile of rows) with the shared memory `sm` it is given; an `*_item`
// function is the work of one thread on one element or one row. Most
// blocks are block-strided over `threadIdx.x` with a `__syncthreads()`
// after each phase and keep their state in `sm`; the two products,
// `bmm_block` and `mm2d_block`, are register-tiled: each thread keeps a
// tile of the outputs in registers (their geometry is defined here, for
// csrc/calib.cu and the host harness alike). Nothing else runs in them,
// so the CPU tests compile this header with g++ under csrc/host_shim.h
// and run it.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#include <cuda_pipeline_primitives.h>
#endif

namespace calib {

template <typename T>
__device__ __forceinline__ T rsq(T x) { return T(1) / sqrt(x); }

__device__ __forceinline__ int tid() { return (int)threadIdx.x; }
__device__ __forceinline__ int nthreads() { return (int)blockDim.x; }

// acc + a * 1.0001 + acc * a, per element
template <typename T>
__device__ void ew_item(long long i, const T* a, T* out, int iters) {
  const T ai = a[i];
  T acc = 0;
  for (int it = 0; it < iters; ++it) acc = acc + ai * T(1.0001) + acc * ai;
  out[i] = acc;
}

// M = a + acc; for each column j: d = rsqrt(|M_jj| + 1), c = M[:, j] d
// (rows above j zero when masked), M -= c c^T. sm: w*w + w
template <typename T>
__device__ void chol_sweep_block(int w, bool masked, const T* a, T* out,
                                 int iters, T* sm) {
  const int t = tid(), nt = nthreads(), ww = w * w;
  T* M = sm;
  T* c = sm + ww;
  for (int e = t; e < ww; e += nt) M[e] = 0;
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    for (int e = t; e < ww; e += nt) M[e] = a[e] + M[e];
    __syncthreads();
    for (int j = 0; j < w; ++j) {
      const T d = rsq(fabs(M[j * w + j]) + T(1));
      for (int i = t; i < w; i += nt)
        c[i] = (!masked || i >= j) ? M[i * w + j] * d : T(0);
      __syncthreads();
      for (int e = t; e < ww; e += nt) M[e] = M[e] - c[e / w] * c[e % w];
      __syncthreads();
    }
  }
  for (int e = t; e < ww; e += nt) out[e] = M[e];
}

// ---- the register-tiled products: bmm and mm2d ----
//
// Both are acc[R][C] += x y^T over k on a tile of the outputs that a
// thread keeps in registers for the whole loop; per k it reads R + C
// words from shared memory (as 8- or 16-byte vectors where they are
// contiguous) for R C FMAs, where the one-element loop read two words
// (and divided an index) for each FMA. On an H100 the shared-memory pipe
// delivers 128 bytes a cycle to the lanes of an SM: a warp's 4-, 8- or
// 16-byte load costs it 1, 2 or 4 cycles (half that when all 32 lanes
// read one address), against 4 warp FMAs a cycle (diag/pipe_probe.py
// measures both). So a tile of R x C costs about R + C pipe cycles a warp
// for R C / 4 FMA cycles, and the pipe is the limit: 6 x 6 for bmm (12
// cycles for 36 FMAs; wider tiles need more registers than float64 has),
// 4 x 3 for mm2d, whose x is one broadcast vector (5 cycles for 12 FMAs).

// N consecutive T from shared memory at p (aligned to N T, N = 1, 2, 4):
// one access (two for four doubles). On the card the loads are volatile
// asm, which the compiler does not move down next to their use, as it
// moves plain loads (with those the products ran slower on an H100).
template <typename T, int N>
__device__ __forceinline__ void lds(const T* p, T* r) {
#if defined(__CUDA_ARCH__)
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  if constexpr (sizeof(T) == 4 && N == 4)
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(r[0]), "=f"(r[1]), "=f"(r[2]), "=f"(r[3])
                 : "r"(a));
  else if constexpr (sizeof(T) == 4 && N == 2)
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                 : "=f"(r[0]), "=f"(r[1]) : "r"(a));
  else if constexpr (sizeof(T) == 4)
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(r[0]) : "r"(a));
  else if constexpr (N == 4) {
    lds<T, 2>(p, r);
    lds<T, 2>(p + 2, r + 2);
  } else if constexpr (N == 2)
    asm volatile("ld.shared.v2.f64 {%0, %1}, [%2];"
                 : "=d"(r[0]), "=d"(r[1]) : "r"(a));
  else
    asm volatile("ld.shared.f64 %0, [%1];" : "=d"(r[0]) : "r"(a));
#else
  for (int i = 0; i < N; ++i) r[i] = p[i];
#endif
}

// N = 4 or 6 consecutive T at p into r, in vectors of 4 or 2
template <typename T, int N>
__device__ __forceinline__ void lds_run(const T* p, T* r) {
  constexpr int V = N % 4 == 0 ? 4 : 2;
#pragma unroll
  for (int i = 0; i < N; i += V) lds<T, V>(p + i, r + i);
}

// one k's operands: x = X[k xp ..] (R contiguous), y = Y[k yp + m YS]
// (C contiguous when YS is 1, else one scalar a column)
template <typename T, int R, int C, int YS>
__device__ __forceinline__ void load_k(int k, const T* X, int xp, const T* Y,
                                       int yp, T (&x)[R], T (&y)[C]) {
  lds_run<T, R>(X + k * xp, x);
  if constexpr (YS == 1) {
    lds_run<T, C>(Y + k * yp, y);
  } else {
#pragma unroll
    for (int m = 0; m < C; ++m) lds<T, 1>(Y + k * yp + m * YS, y + m);
  }
}

// acc[r][m] += x[r] y[m]
template <typename T, int R, int C>
__device__ __forceinline__ void outer_fma(T (&acc)[R][C], const T (&x)[R],
                                          const T (&y)[C]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < C; ++m) acc[r][m] += x[r] * y[m];
}

// the k range of product_k_loop with passes of K k: w rounded up to a
// multiple of K (the operands' rows from w on are zero)
template <int K>
__host__ __device__ constexpr int k_rows(int w) { return (w + K - 1) / K * K; }

// acc[r][m] += sum_{k < k_rows<2 NP>(w)} X[k xp + r] Y[k yp + m YS] (rows
// k >= w of X and Y zero), in passes of NP pairs of k. NS operand sets of
// one pair each rotate: a pair's loads issue NS - 1 pairs before its FMAs.
// The compiler places loads whose values are used only in the next pass
// at the end of a pass, where they stall the next pass's first FMAs, so
// a pass is long (NS - 1 such pairs in NP). The body has no branch: the
// zero rows make a ragged w exact, and the loads past the last pass
// re-read row k_rows - 1.
template <typename T, int R, int C, int YS, int NS, int NP>
__device__ __forceinline__ void product_k_loop(T (&acc)[R][C], int w,
                                               const T* X, int xp,
                                               const T* Y, int yp) {
  static_assert(NP % NS == 0, "a pass holds whole rotations of the sets");
  T x[NS][2][R], y[NS][2][C];
  const int kn = k_rows<2 * NP>(w), last = kn - 1;
#pragma unroll
  for (int q = 0; q < NS - 1; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      load_k<T, R, C, YS>(2 * q + h, X, xp, Y, yp, x[q][h], y[q][h]);
  for (int k = 0; k < kn; k += 2 * NP) {
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int ahead = q + NS - 1, set = ahead % NS;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int kk = k + 2 * ahead + h;
        if (ahead >= NP) kk = kk < last ? kk : last;
        load_k<T, R, C, YS>(kk, X, xp, Y, yp, x[set][h], y[set][h]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) outer_fma(acc, x[q % NS][h], y[q % NS][h]);
    }
  }
}

// bmm's geometry: a thread owns a kBmmTile x kBmmTile tile of the (w, w)
// matrix (nT = ceil(w / 6) tiles a side, the ragged edge masked); at most
// 256 threads a block, so w <= 96 (16 x 16 tiles). The launch takes the
// tiles rounded up to whole warps (w = 96: 256 threads, w = 48: 64, so
// that the 240 matrices of w = 48 are all resident at once, two an SM).
constexpr int kBmmTile = 6;
constexpr int kBmmSets = 2, kBmmPairs = 8;   // product_k_loop's NS, NP
constexpr int kBmmK = 2 * kBmmPairs;
constexpr int kBmmMaxThreads = 256;
constexpr int kBmmMaxWidth = 96;
__host__ __device__ constexpr int bmm_tiles(int w) {
  return (w + kBmmTile - 1) / kBmmTile;
}
__host__ __device__ constexpr int bmm_pitch(int w) {
  return kBmmTile * bmm_tiles(w);
}
__host__ __device__ constexpr int bmm_threads(int w) {
  return 32 * ((bmm_tiles(w) * bmm_tiles(w) + 31) / 32);
}
// elements of shared memory: A^T and two buffers of Bm, k_rows<kBmmK>(w)
// x pitch each: 3 w^2 where 48 divides w, as at the probes' 48 and 96
// (110.6 KB at w = 96 in float32, one block an SM)
__host__ __device__ constexpr long long bmm_smem(int w) {
  return 3LL * k_rows<kBmmK>(w) * bmm_pitch(w);
}

// acc + a @ (a + s acc) on one (w, w) block, w <= kBmmMaxWidth, with
// bmm_threads(w) threads (more only idle). Shared memory (bmm_smem):
// At[k P + i] = a[i][k], so that the 6 rows of a tile for one k are
// contiguous, and Bm = a + s acc in two buffers Bm[k P + j], which each
// thread writes for its own tile from its registers, so a step needs one
// barrier: the buffer written at step it was last read at step it - 2,
// before the barrier of step it - 1. Entries past w are zero.
template <typename T>
__device__ void bmm_block(int w, T s, const T* a, T* out, int iters,
                          T* sm) {
  constexpr int R = kBmmTile;
  const int t = tid(), nt = nthreads(), P = bmm_pitch(w), nT = bmm_tiles(w),
            kn = k_rows<kBmmK>(w);
  T* At = sm;
  T* Bm = sm + kn * P;
  for (int e = t; e < 3 * kn * P; e += nt) sm[e] = T(0);
  __syncthreads();
  for (int e = t; e < w * w; e += nt)     // coalesced reads of a
    At[(e % w) * P + e / w] = a[e];
  const bool own = t < nT * nT;
  const int i0 = own ? R * (t / nT) : 0, j0 = own ? R * (t % nT) : 0;
  T at[R][R], acc[R][R];                  // the tile of a, the outputs
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int n = 0; n < R; ++n) {
      const int i = i0 + m, j = j0 + n;
      at[m][n] = i < w && j < w ? a[i * w + j] : T(0);
      acc[m][n] = T(0);
    }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    T* B = Bm + (it & 1) * kn * P;
    if (own) {
#pragma unroll
      for (int m = 0; m < R; ++m)
#pragma unroll
        for (int n = 0; n < R; ++n)
          if (i0 + m < w) B[(i0 + m) * P + j0 + n] = at[m][n] + s * acc[m][n];
    }
    __syncthreads();
    if (own)
      product_k_loop<T, R, R, 1, kBmmSets, kBmmPairs>(acc, w, At + i0, P,
                                                       B + j0, P);
  }
  if (!own) return;
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int n = 0; n < R; ++n)
      if (i0 + m < w && j0 + n < w) out[(i0 + m) * w + j0 + n] = acc[m][n];
}

// mm2d's geometry: a block of kMmWarps warps owns kMmRowsPerBlock rows, a
// warp kMmRows of them; lane l keeps the kMmRows x kMmCols outputs of its
// warp's rows at columns l, l + 32, l + 64 (masked past w), so w <= 96.
constexpr int kMmRows = 4;
constexpr int kMmSets = 3, kMmPairs = 24;     // product_k_loop's NS, NP
constexpr int kMmK = 2 * kMmPairs;
constexpr int kMmCols = 3;
constexpr int kMmWarps = 4;
constexpr int kMmThreads = 32 * kMmWarps;
constexpr int kMmRowsPerBlock = kMmRows * kMmWarps;
constexpr int kMmPitch = 32 * kMmCols;
constexpr int kMmMaxWidth = kMmPitch;
// elements of shared memory: top (k_rows<kMmK>(w) x 96) and each warp's
// X^T, two buffers of k_rows<kMmK>(w) x 4
__host__ __device__ constexpr long long mm2d_smem(int w) {
  return (long long)k_rows<kMmK>(w) * (kMmPitch + 2 * kMmWarps * kMmRows);
}

// rows [r0, r0 + kMmRowsPerBlock) of acc + (a + acc) @ a[:w] on (rows, w),
// w <= kMmMaxWidth, with kMmThreads threads. A row's step needs only that
// row, so a warp owns its rows: it writes X = a + acc for them into its
// own buffer X[k 4 + r] (two in turn, so one __syncwarp a step) and reads
// it back as one broadcast vector per k, two pairs of k ahead (one warp a
// scheduler: a k has only 12 FMAs to cover a load); top[k 96 + c] =
// a[k][c] (zero for c >= w or k >= w) is copied in once with cp.async. No
// block barrier runs inside the loop.
template <typename T>
__device__ void mm2d_block(int rows, int w, int r0, const T* a, T* out,
                           int iters, T* sm) {
  constexpr int RW = kMmRows, CL = kMmCols;
  const int t = tid(), lane = t % 32, wp = t / 32, kn = k_rows<kMmK>(w);
  T* top = sm;
  T* X = sm + kn * kMmPitch + 2 * wp * kn * RW;
  for (int e = t; e < kn * kMmPitch; e += nthreads()) {
    const int k = e / kMmPitch, c = e % kMmPitch;
    if (k < w && c < w)
      __pipeline_memcpy_async(top + e, a + k * w + c, sizeof(T));
    else
      top[e] = T(0);
  }
  __pipeline_commit();
  for (int e = lane; e < (kn - w) * RW; e += 32)
    X[w * RW + e] = X[(kn + w) * RW + e] = T(0);
  const int rw = r0 + wp * RW;            // this warp's first row
  T ar[RW][CL], acc[RW][CL];              // its rows of a, the outputs
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int m = 0; m < CL; ++m) {
      const int row = rw + r, c = lane + 32 * m;
      ar[r][m] = row < rows && c < w ? a[(long long)row * w + c] : T(0);
      acc[r][m] = T(0);
    }
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    T* Xb = X + (it & 1) * kn * RW;
#pragma unroll
    for (int m = 0; m < CL; ++m) {
      const int c = lane + 32 * m;
#pragma unroll
      for (int r = 0; r < RW; ++r)
        if (c < w) Xb[c * RW + r] = ar[r][m] + acc[r][m];
    }
    __syncwarp();
    product_k_loop<T, RW, CL, 32, kMmSets, kMmPairs>(acc, w, Xb, RW,
                                                     top + lane, kMmPitch);
  }
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int m = 0; m < CL; ++m) {
      const int row = rw + r, c = lane + 32 * m;
      if (row < rows && c < w) out[(long long)row * w + c] = acc[r][m];
    }
}

// acc * s + sum_k A[k, o] v[k] for a (R, C) block: k = r, o = c, or with
// trans k = c, o = r. The block is stored k-major in sm, so that threads
// on neighbouring outputs read neighbouring words. sm: R*C + Kc
template <typename T>
__device__ void matvec_block(int R, int C, bool trans, T s, const T* a,
                             const T* v, T* out, int iters, T* sm) {
  const int t = tid(), nt = nthreads(), RC = R * C;
  const int O = trans ? R : C, Kc = trans ? C : R;
  T* L = sm;
  T* vs = sm + RC;
  for (int e = t; e < RC; e += nt) {
    const int r = e / C, c = e % C;
    L[trans ? c * R + r : e] = a[e];
  }
  for (int k = t; k < Kc; k += nt) vs[k] = v[k];
  __syncthreads();
  for (int o = t; o < O; o += nt) {
    T acc = 0;
    for (int it = 0; it < iters; ++it) {
      T x = acc * s;
      for (int k = 0; k < Kc; ++k) x = x + L[k * O + o] * vs[k];
      acc = x;
    }
    out[o] = acc;
  }
}

// M - c c^T with c = M[:, 0] * 1e-3, from M = a. sm: w*w + w
template <typename T>
__device__ void rank1_block(int w, const T* a, T* out, int iters, T* sm) {
  const int t = tid(), nt = nthreads(), ww = w * w;
  T* M = sm;
  T* c = sm + ww;
  for (int e = t; e < ww; e += nt) M[e] = a[e];
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    for (int i = t; i < w; i += nt) c[i] = M[i * w] * T(1e-3);
    __syncthreads();
    for (int e = t; e < ww; e += nt) M[e] = M[e] - c[e / w] * c[e % w];
    __syncthreads();
  }
  for (int e = t; e < ww; e += nt) out[e] = M[e];
}

// one row of the lane-flat 8x8 sweep: Mc = M + M0 1e-6, then for each
// j < 8, d = rsqrt(|Mc[9 j]| + 1), r = Mc[8 j : 8 j + 8] d,
// Mc[8 i + k] -= r_i r_k; the row lives in registers
template <typename T>
__device__ void chol8flat_item(long long row, const T* M0, T* out,
                               int iters) {
  T m0[64], mc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    m0[e] = M0[row * 64 + e];
    mc[e] = 0;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int e = 0; e < 64; ++e) mc[e] = mc[e] + m0[e] * T(1e-6);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const T d = rsq(fabs(mc[9 * j]) + T(1));
      T r[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) r[k] = mc[8 * j + k] * d;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int k = 0; k < 8; ++k) mc[8 * i + k] = mc[8 * i + k] - r[i] * r[k];
    }
  }
#pragma unroll
  for (int e = 0; e < 64; ++e) out[row * 64 + e] = mc[e];
}

// acc * 1e-6 + (a + acc * 1e-6)^T on one (w, w) block. sm: 3 w*w
template <typename T>
__device__ void transpose_block(int w, const T* a, T* out, int iters, T* sm) {
  const int t = tid(), nt = nthreads(), ww = w * w;
  const T s = T(1e-6);
  T* A = sm;
  T* acc = sm + ww;
  T* nxt = sm + 2 * ww;
  for (int e = t; e < ww; e += nt) {
    A[e] = a[e];
    acc[e] = 0;
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    for (int e = t; e < ww; e += nt) {
      const int i = e / w, j = e % w, et = j * w + i;
      nxt[e] = acc[e] * s + (A[et] + acc[et] * s);
    }
    __syncthreads();
    T* tmp = acc;
    acc = nxt;
    nxt = tmp;
  }
  for (int e = t; e < ww; e += nt) out[e] = acc[e];
}

// a + 1, per element of the (n, 8, 8) block read as (n, 64)
template <typename T>
__device__ void reshape88_item(long long i, const T* a, T* out) {
  out[i] = a[i] + T(1);
}

// zeros, with row 5 := a[3, :] + a[7, :] at every step. sm: w*w
template <typename T>
__device__ void slice_mix_block(int w, const T* a, T* out, int iters,
                                T* sm) {
  const int t = tid(), nt = nthreads(), ww = w * w;
  for (int e = t; e < ww; e += nt) sm[e] = 0;
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    for (int j = t; j < w; j += nt) sm[5 * w + j] = a[3 * w + j] + a[7 * w + j];
    __syncthreads();
  }
  for (int e = t; e < ww; e += nt) out[e] = sm[e];
}

}  // namespace calib
