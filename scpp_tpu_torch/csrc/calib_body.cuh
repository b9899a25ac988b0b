// Device bodies of the calibration probes (csrc/calib.cu): each function
// of scpp_tpu_torch/diag/calib.py, looped `iters` dependent steps inside
// one launch. The plain versions are the `_<name>_plain` functions there.
//
// A `*_block` function is the work of one thread block on one matrix (or
// one tile of rows), block-strided over `threadIdx.x` with a
// `__syncthreads()` after each phase, and keeps its state in the shared
// memory `sm` it is given; an `*_item` function is the work of one thread
// on one element or one row. Nothing else runs in them, so the CPU tests
// compile this header with g++ under csrc/host_shim.h and run it.
#pragma once

#include <math.h>

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

// acc + a @ (a + s acc) on one (w, w) block. sm: 3 w*w
template <typename T>
__device__ void bmm_block(int w, T s, const T* a, T* out, int iters, T* sm) {
  const int t = tid(), nt = nthreads(), ww = w * w;
  T* A = sm;
  T* Bm = sm + ww;
  T* acc = sm + 2 * ww;
  for (int e = t; e < ww; e += nt) {
    A[e] = a[e];
    acc[e] = 0;
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    for (int e = t; e < ww; e += nt) Bm[e] = A[e] + s * acc[e];
    __syncthreads();
    for (int e = t; e < ww; e += nt) {
      const int i = e / w, j = e % w;
      T dot = 0;
      for (int k = 0; k < w; ++k) dot += A[i * w + k] * Bm[k * w + j];
      acc[e] = acc[e] + dot;
    }
    __syncthreads();
  }
  for (int e = t; e < ww; e += nt) out[e] = acc[e];
}

// rows [r0, r0 + nr) of acc + (a + acc) @ a[:w] on (rows, w); the steps
// of a row need only that row. sm: w*w + 2 nr*w
template <typename T>
__device__ void mm2d_block(int w, int r0, int nr, const T* a, T* out,
                           int iters, T* sm) {
  const int t = tid(), nt = nthreads(), ww = w * w, n = nr * w;
  T* top = sm;
  T* X = sm + ww;
  T* acc = X + n;
  for (int e = t; e < ww; e += nt) top[e] = a[e];
  for (int e = t; e < n; e += nt) acc[e] = 0;
  __syncthreads();
  const T* arow = a + (long long)r0 * w;
  for (int it = 0; it < iters; ++it) {
    for (int e = t; e < n; e += nt) X[e] = arow[e] + acc[e];
    __syncthreads();
    for (int e = t; e < n; e += nt) {
      const int i = e / w, j = e % w;
      T dot = 0;
      for (int k = 0; k < w; ++k) dot += X[i * w + k] * top[k * w + j];
      acc[e] = acc[e] + dot;
    }
    __syncthreads();
  }
  for (int e = t; e < n; e += nt) out[(long long)r0 * w + e] = acc[e];
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
