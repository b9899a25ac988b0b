// Device body of the cyclic-reduction KKT solve: one thread block solves
// M x = b for one scenario from the factor of
// scpp_tpu_torch/solver/staged_kkt.py:cr_factor, as the plain version
// `cr_solve` does for a batch. See cr_solve.cu for the kernel entry and
// what bounds it on the card.
//
// Layouts (per scenario, row-major):
//   blocks (K-1, 3, Wp, Wp): the odd blocks of every level in level order,
//     each as (L^{-1}, R, Q); level l holds n_l / 2 of them
//   root (Wp, Wp): L^{-1} of the last remaining block
//   b, x (K, Wp)
// Transposed blocks are read by index, never stored. Within a level the
// odd blocks are independent: each (block, row) pair is one work item of
// a block-strided loop, every dot product runs over its Wp terms in a
// fixed order (no atomics, so the result does not depend on the thread
// count), and each dependent step ends in __syncthreads(). The level's
// right-hand sides live in shared memory. The dot products are unrolled
// by 16, so that a thread has 16 reads of the factor in flight.
#pragma once

namespace cr {

constexpr int kMaxLevels = 32;

// Shared memory of one block, in elements: the current and the next
// vectors (K x Wp each), the down-sweep values t of every odd block
// ((K-1) x Wp), the up-sweep's scaled right-hand sides ((K/2) x Wp) and
// the root's intermediate (Wp).
__host__ __device__ inline long long smem_elems(int K, int Wp) {
  return (2LL * K + (K - 1) + K / 2 + 1) * Wp;
}

template <typename T>
__device__ __forceinline__ T sig(int a, int p) { return a < p ? T(1) : T(-1); }

template <typename T>
__device__ void solve(int K, int Wp, int p, const T* blocks, const T* root,
                      const T* b, T* x, T* smem) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long WW = (long long)Wp * Wp;
  T* cur = smem;
  T* nxt = cur + (long long)K * Wp;
  T* ts = nxt + (long long)K * Wp;
  T* srhs = ts + (long long)(K - 1) * Wp;
  T* u = srhs + (long long)(K / 2) * Wp;

  // the static level structure: blocks n, odd blocks o, first odd block
  int lv_n[kMaxLevels], lv_off[kMaxLevels], nlev = 0;
  for (int n = K, off = 0; n > 1; n -= n / 2) {
    lv_n[nlev] = n;
    lv_off[nlev++] = off;
    off += n / 2;
  }

  for (int i = tid; i < K * Wp; i += nt) cur[i] = b[i];
  __syncthreads();

  // ---- down-sweep ----
  for (int l = 0; l < nlev; ++l) {
    const int n = lv_n[l], o = n / 2, ne = n - o, off = lv_off[l];
    // t_m = L_m^{-1} b_{2m+1}
    for (int i = tid; i < o * Wp; i += nt) {
      const int m = i / Wp, a = i % Wp;
      const T* Li = blocks + (off + m) * 3 * WW + (long long)a * Wp;
      const T* v = cur + (2 * m + 1) * Wp;
      T acc = T(0);
      #pragma unroll 16
      for (int c = 0; c < Wp; ++c) acc += Li[c] * v[c];
      ts[(off + m) * Wp + a] = acc;
    }
    __syncthreads();
    // b_{2m} -= R_m' S t_m + Q_{m-1}' S t_{m-1}
    for (int i = tid; i < ne * Wp; i += nt) {
      const int m = i / Wp, c = i % Wp;
      T v = cur[2 * m * Wp + c];
      if (m < o) {
        const T* R = blocks + ((off + m) * 3 + 1) * WW;
        const T* t = ts + (off + m) * Wp;
        T acc = T(0);
        #pragma unroll 16
        for (int a = 0; a < Wp; ++a) acc += R[(long long)a * Wp + c] * (sig<T>(a, p) * t[a]);
        v -= acc;
      }
      if (m >= 1) {
        const T* Q = blocks + ((off + m - 1) * 3 + 2) * WW;
        const T* t = ts + (off + m - 1) * Wp;
        T acc = T(0);
        #pragma unroll 16
        for (int a = 0; a < Wp; ++a) acc += Q[(long long)a * Wp + c] * (sig<T>(a, p) * t[a]);
        v -= acc;
      }
      nxt[m * Wp + c] = v;
    }
    __syncthreads();
    T* tmp = cur; cur = nxt; nxt = tmp;
  }

  // ---- root: x_0 = L^{-T} S L^{-1} b_0 ----
  for (int a = tid; a < Wp; a += nt) {
    const T* Li = root + (long long)a * Wp;
    T acc = T(0);
    #pragma unroll 16
    for (int c = 0; c < Wp; ++c) acc += Li[c] * cur[c];
    u[a] = sig<T>(a, p) * acc;
  }
  __syncthreads();
  for (int c = tid; c < Wp; c += nt) {
    T acc = T(0);
    #pragma unroll 16
    for (int a = 0; a < Wp; ++a) acc += root[(long long)a * Wp + c] * u[a];
    nxt[c] = acc;
  }
  __syncthreads();
  { T* tmp = cur; cur = nxt; nxt = tmp; }

  // ---- up-sweep ----
  for (int l = nlev - 1; l >= 0; --l) {
    const int n = lv_n[l], o = n / 2, ne = n - o, off = lv_off[l];
    // S (t_m - R_m x_m - Q_m x_{m+1}), x_{m+1} = 0 past the last block
    for (int i = tid; i < o * Wp; i += nt) {
      const int m = i / Wp, a = i % Wp;
      const T* R = blocks + ((off + m) * 3 + 1) * WW + (long long)a * Wp;
      const T* xm = cur + m * Wp;
      T accR = T(0);
      #pragma unroll 16
      for (int c = 0; c < Wp; ++c) accR += R[c] * xm[c];
      T accQ = T(0);
      if (m + 1 < ne) {
        const T* Q = blocks + ((off + m) * 3 + 2) * WW + (long long)a * Wp;
        const T* xn = cur + (m + 1) * Wp;
        #pragma unroll 16
        for (int c = 0; c < Wp; ++c) accQ += Q[c] * xn[c];
      }
      srhs[m * Wp + a] = sig<T>(a, p) * (ts[(off + m) * Wp + a] - accR - accQ);
    }
    __syncthreads();
    // x_{2m} = x_m (even), x_{2m+1} = L_m^{-T} S rhs_m (odd)
    for (int i = tid; i < n * Wp; i += nt) {
      const int j = i / Wp, c = i % Wp;
      if (j % 2 == 0) {
        nxt[i] = cur[(j / 2) * Wp + c];
      } else {
        const int m = j / 2;
        const T* Li = blocks + (off + m) * 3 * WW;
        const T* r = srhs + m * Wp;
        T acc = T(0);
        #pragma unroll 16
        for (int a = 0; a < Wp; ++a) acc += Li[(long long)a * Wp + c] * r[a];
        nxt[i] = acc;
      }
    }
    __syncthreads();
    T* tmp = cur; cur = nxt; nxt = tmp;
  }

  for (int i = tid; i < K * Wp; i += nt) x[i] = cur[i];
}

}  // namespace cr
