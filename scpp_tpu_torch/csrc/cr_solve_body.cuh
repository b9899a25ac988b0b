// Device body of the cyclic-reduction KKT solve: one thread block solves
// M x = b for one scenario from the factor of
// scpp_tpu_torch/solver/staged_kkt.py:cr_factor, as the plain version
// `cr_solve` does for a batch. See cr_solve.cu for the kernel entry and
// what bounds it on the card; kernel 1 (mono_ipm_body.cuh) runs the same
// body as its KKT solve.
//
// Layouts (per scenario, row-major):
//   blocks (K-1, 3, Wp, Wp): the odd blocks of every level in level order,
//     each as (L^{-1}, R, Q); level l holds n_l / 2 of them
//   root (Wp, Wp): L^{-1} of the last remaining block
//   b, x (K, Wp)
//
// The factor streams through a ring of D slots in shared memory, one odd
// block's contiguous (L^{-1}, R, Q) a slot, in the order the sweeps use
// them: blocks 0 .. K-2 down, K-2 .. 0 up. Block j always lives in slot
// j mod D, so the last D blocks of the down-sweep are still resident when
// the up-sweep starts with them, and the others are copied in again. The
// copies do not depend on b, so they run ahead of the dependent chain:
// at the end of every chunk of blocks one thread (the producer, the
// block's last) issues every copy whose slot is free and waits for the
// next chunk's blocks, and the barrier that ends the chunk passes them
// on to all threads. Where rows are 16-byte multiples at 16-byte
// addresses (FAST) a copy is one TMA bulk copy completing on its slot's
// mbarrier (b and the root have one of their own, copied first);
// otherwise every thread copies its share of elements by cp.async and
// waits for them all.
//
// A level's odd blocks are taken in chunks of at most max(1, D / 2)
// blocks; a chunk's slots are freed one chunk late, after a barrier has
// passed their last reads, so the ring holds two chunks and each chunk's
// copies have the previous chunk's steps to arrive. Every block's
// products are computed whole within its chunk, each dot product over
// its Wp terms in a fixed order (four running sums, no atomics), and an
// even block's update subtracts its R term and then its left
// neighbour's Q term whichever chunk held that neighbour: neither the
// ring's depth nor the thread count changes a result.
//
// Work items: a chunk's rows (or columns) are items, packed densely, one
// a thread. Column products (R' S t, Q' S t, L^{-T} r) read consecutive
// words across a warp, and the slots of neighbouring blocks start 16
// banks apart, so a warp that spans two blocks reads without conflicts.
// Row products (L^{-1} b, R x, Q x) read a row per thread, Wp words
// apart: row a starts its sum at column (FAST: 16-byte chunk) skew(a)
// and wraps, which spreads a warp's reads over all banks at the flagship
// Wp = 48 in both types (2-3 way conflicts at worst elsewhere). FAST
// products read 16 bytes at a time, their loads 16 terms ahead of their
// multiply-adds. Every step is a chain of shared-memory latencies, and
// the code is kept small (one call site a product, loops not unrolled
// beyond a batch of loads): the instruction cache must hold a chunk's
// steps, or every step pays to fetch them again.
#pragma once

#ifdef __CUDACC__
#include <cuda_pipeline_primitives.h>

// ---- the asynchronous-copy primitives (host_shim.h has their host
// counterparts) ----
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
// makes the initialized mbarriers visible to the async proxy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// true once the phase of this parity has completed
__device__ __forceinline__ bool mbar_try_wait(unsigned long long* bar,
                                              unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ void mbar_inval(unsigned long long* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}
// one TMA bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              unsigned bytes,
                                              unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// orders this thread's earlier generic-proxy accesses (global and shared)
// before later async-proxy ones (the bulk copies), and the reverse
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;" ::: "memory");
}
#endif

namespace cr {

constexpr int kMaxLevels = 32;
constexpr int kWarp = 32;

__host__ __device__ inline long long align16(long long n) {
  return (n + 15) / 16 * 16;
}

// the solve's vectors, in elements: the current and the next vectors
// (K x Wp each), the down-sweep values t of every odd block
// ((K-1) x Wp), the down-sweep's carried Q terms and the up-sweep's
// scaled right-hand sides (ceil(K/2) x Wp, one after the other), the
// root's intermediate (Wp)
__host__ __device__ inline long long vec_elems(int K, int Wp) {
  return (2LL * K + (K - 1) + (K + 1) / 2 + 1) * Wp;
}

// a ring slot, in bytes: one odd block's (L^{-1}, R, Q), rounded up to
// 64 bytes past a multiple of 128, so that the slots of neighbouring
// blocks start 16 banks apart (a warp may span two blocks)
__host__ __device__ inline long long slot_bytes(int Wp, int eb) {
  return (3LL * Wp * Wp * eb + 63) / 128 * 128 + 64;
}

// Shared memory of a solve with a ring of `slots` slots, in bytes of an
// `eb`-byte type: the mbarriers (a slot's and the root's), the vectors,
// the root, the ring; each region 16-byte aligned.
__host__ __device__ inline long long smem_bytes(int K, int Wp, int slots,
                                                int eb) {
  const long long WW = (long long)Wp * Wp;
  return align16(8LL * (slots + 1)) + align16(vec_elems(K, Wp) * eb) +
         align16(WW * eb) + slots * slot_bytes(Wp, eb);
}

// The ring's depth in a budget of `budget` bytes: as many slots as fit,
// at most one a factor block (K - 1, and at least 1) and at most 31 (a
// bit each of the producer's parity word, and the root's); 0 if not one
// fits.
__host__ __device__ inline int ring_slots(int K, int Wp, long long budget,
                                          int eb) {
  const int most = K > 32 ? 31 : K > 2 ? K - 1 : 1;
  int d = 0;
  while (d < most && smem_bytes(K, Wp, d + 1, eb) <= budget) ++d;
  return d;
}

// The least shared memory of a solve (a ring of one slot), in elements of
// an `eb`-byte type, rounded up.
__host__ __device__ inline long long smem_elems(int K, int Wp, int eb) {
  return (smem_bytes(K, Wp, 1, eb) + eb - 1) / eb;
}

template <typename T>
__device__ __forceinline__ T sig(int a, int p) { return a < p ? T(1) : T(-1); }

// first column of row a's sum in a row of n elements, or first 16-byte
// chunk in a row of C = n / (16 / sizeof(T)) chunks (`vec`): see the note
// at the top
template <typename T>
__device__ __forceinline__ int skew(int a, int n, bool vec) {
  if (vec) {
    const int C = n / (16 / (int)sizeof(T));
    return (C % 8 == 4 ? a >> 1 : a) % C;
  }
  return (sizeof(T) == 4 && n % 32 == 16 ? a >> 1 : a) % n;
}

// sum_c f[c] v[c] over c = s, s+1, .., n-1, 0, .., s-1, four running sums
template <typename T>
__device__ __forceinline__ T dot_row(const T* __restrict__ f,
                                     const T* __restrict__ v, int n, int s) {
  T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
  int k = 0;
  for (; k + 4 <= n; k += 4) {
    int c0 = s + k, c1 = c0 + 1, c2 = c0 + 2, c3 = c0 + 3;
    c0 -= c0 >= n ? n : 0;
    c1 -= c1 >= n ? n : 0;
    c2 -= c2 >= n ? n : 0;
    c3 -= c3 >= n ? n : 0;
    a0 += f[c0] * v[c0];
    a1 += f[c1] * v[c1];
    a2 += f[c2] * v[c2];
    a3 += f[c3] * v[c3];
  }
  for (; k < n; ++k) {
    int c = s + k;
    c -= c >= n ? n : 0;
    a0 += f[c] * v[c];
  }
  return (a0 + a1) + (a2 + a3);
}

// the same over 16-byte chunks (rows of C chunks, 16-byte aligned), chunk
// s first: a float chunk's four terms go to the four sums, a double
// chunk's two to two of them, in turn. The loads go out 16 terms at a
// time, ahead of their products: a step is a chain of shared-memory
// loads.
__device__ __forceinline__ float dot_row16(const float* __restrict__ f,
                                           const float* __restrict__ v,
                                           int C, int s) {
  const float4* fr = reinterpret_cast<const float4*>(f);
  const float4* vr = reinterpret_cast<const float4*>(v);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  #pragma unroll 1
  for (int k = 0; k < C; k += 4) {
    float4 x[4], y[4];
    #pragma unroll
    for (int e = 0; e < 4; ++e) {
      int c = s + k + e;
      c -= c >= C ? C : 0;
      c = k + e < C ? c : s;  // past the row: a chunk read, not summed
      x[e] = fr[c];
      y[e] = vr[c];
    }
    #pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (k + e < C) {
        a0 += x[e].x * y[e].x;
        a1 += x[e].y * y[e].y;
        a2 += x[e].z * y[e].z;
        a3 += x[e].w * y[e].w;
      }
    }
  }
  return (a0 + a1) + (a2 + a3);
}
__device__ __forceinline__ double dot_row16(const double* __restrict__ f,
                                            const double* __restrict__ v,
                                            int C, int s) {
  const double2* fr = reinterpret_cast<const double2*>(f);
  const double2* vr = reinterpret_cast<const double2*>(v);
  double a[4] = {0., 0., 0., 0.};
  #pragma unroll 1
  for (int k = 0; k < C; k += 8) {
    double2 x[8], y[8];
    #pragma unroll
    for (int e = 0; e < 8; ++e) {
      int c = s + k + e;
      c -= c >= C ? C : 0;
      c = k + e < C ? c : s;
      x[e] = fr[c];
      y[e] = vr[c];
    }
    #pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (k + e < C) {
        const int o = (e & 1) * 2;  // chunk k + e, k even: sums by parity
        a[o] += x[e].x * y[e].x;
        a[o + 1] += x[e].y * y[e].y;
      }
    }
  }
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// four elements from 16-byte aligned shared memory, by 16-byte loads
__device__ __forceinline__ void load4(const float* p, float& q0, float& q1,
                                      float& q2, float& q3) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  q0 = x.x;
  q1 = x.y;
  q2 = x.z;
  q3 = x.w;
}
__device__ __forceinline__ void load4(const double* p, double& q0,
                                      double& q1, double& q2, double& q3) {
  const double2 x = reinterpret_cast<const double2*>(p)[0],
                y = reinterpret_cast<const double2*>(p)[1];
  q0 = x.x;
  q1 = x.y;
  q2 = y.x;
  q3 = y.y;
}

// sum_a f[a n] w[a] over a = 0 .. n-1 (a column of an n x n block), four
// running sums (term a to sum a mod 4, the last n mod 4 terms to the
// first)
template <typename T>
__device__ __forceinline__ T dot_col(const T* __restrict__ f,
                                     const T* __restrict__ w, int n) {
  T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
  int a = 0;
  for (; a + 4 <= n; a += 4) {
    a0 += f[a * n] * w[a];
    a1 += f[(a + 1) * n] * w[a + 1];
    a2 += f[(a + 2) * n] * w[a + 2];
    a3 += f[(a + 3) * n] * w[a + 3];
  }
  for (; a < n; ++a) a0 += f[a * n] * w[a];
  return (a0 + a1) + (a2 + a3);
}

// the same with w read 16 bytes at a time (w 16-byte aligned, n a
// multiple of 16 bytes), which all lanes of a warp read at once, and the
// loads 16 terms ahead of their products
template <typename T>
__device__ __forceinline__ T dot_col16(const T* __restrict__ f,
                                       const T* __restrict__ w, int n) {
  T a[4] = {T(0), T(0), T(0), T(0)};
  int k = 0;
  #pragma unroll 1
  for (; k + 16 <= n; k += 16) {
    T q[16], g[16];
    #pragma unroll
    for (int e = 0; e < 16; e += 4)
      load4(w + k + e, q[e], q[e + 1], q[e + 2], q[e + 3]);
    #pragma unroll
    for (int e = 0; e < 16; ++e) g[e] = f[(k + e) * n];
    #pragma unroll
    for (int e = 0; e < 16; ++e) a[e & 3] += g[e] * q[e];
  }
  #pragma unroll 1
  for (; k + 4 <= n; k += 4) {
    #pragma unroll
    for (int e = 0; e < 4; ++e) a[e] += f[(k + e) * n] * w[k + e];
  }
  #pragma unroll 1
  for (; k < n; ++k) a[0] += f[k * n] * w[k];
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// The solve with a ring of D slots. FAST: rows of 16-byte multiples at
// 16-byte addresses, so the blocks come by bulk
// copies and the products read 16 bytes at a time; else element copies
// (cp.async by every thread) and 4- or 8-byte reads.
template <typename T, bool FAST>
__device__ __forceinline__ void solve_ring(int K, int Wp, int p, int D,
                                           const T* blocks, const T* root,
                                           const T* b, T* x, void* smem,
                                           bool fence) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int NB = K - 1;
  const int WW = Wp * Wp;
  const int cmax = D > 1 ? D / 2 : 1;
  const int C = Wp / (16 / (int)sizeof(T));  // 16-byte chunks a row (FAST)

  unsigned char* base = static_cast<unsigned char*>(smem);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(base);
  T* cur = reinterpret_cast<T*>(base + align16(8LL * (D + 1)));
  T* nxt = cur + K * Wp;
  T* ts = nxt + K * Wp;
  T* qs = ts + (K - 1) * Wp;
  T* u = qs + ((K + 1) / 2) * Wp;
  T* rt = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(cur) +
                               align16(vec_elems(K, Wp) * sizeof(T)));
  T* ring = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(rt) +
                                 align16((long long)WW * sizeof(T)));
  const int slot_elems = (int)(slot_bytes(Wp, sizeof(T)) / sizeof(T));
  // the thread that issues the bulk copies and waits for them
  const bool producer = tid == nt - 1;
  // the products of block F (row-major, Wp x Wp) for item r: row r
  // against v, column r against w
  auto row = [&](const T* F, const T* v, int r) {
    return FAST ? dot_row16(F + r * Wp, v, C, skew<T>(r, Wp, true))
                : dot_row(F + r * Wp, v, Wp, skew<T>(r, Wp, false));
  };
  auto col = [&](const T* F, const T* w, int r) {
    return FAST ? dot_col16(F + r, w, Wp) : dot_col(F + r, w, Wp);
  };

  // ---- the ring: load q of the sequence is block q (q < NB, down) or
  // block 2 NB - D - 1 - q (up: the blocks below the last D, descending);
  // block j in slot j mod D. Every thread keeps this state (the element
  // copies take all threads); with bulk copies only the producer copies
  // and waits, and a barrier passes the data on.
  const int NQ = NB + (NB > D ? NB - D : 0);
  int q_next = 0, s_next = 0, done_down = 0, done_up = 0, pend = 0;
  unsigned phase = 0;  // the parity each slot's mbarrier waits for next
  auto copy_in = [&](T* dst, const T* src, int n, unsigned long long* bar) {
    if (FAST) {
      if (producer) {
        mbar_arrive_expect_tx(bar, (unsigned)(n * sizeof(T)));
        bulk_copy_g2s(dst, src, (unsigned)(n * sizeof(T)), bar);
      }
    } else {
      for (int e = tid; e < n; e += nt)
        __pipeline_memcpy_async(dst + e, src + e, sizeof(T));
      __pipeline_commit();
    }
  };
  // every copy whose slot is free: a slot is free once its last block's
  // use in this sweep is done
  auto issue = [&]() {
    while (q_next < NQ) {
      const int j = q_next < NB ? q_next : 2 * NB - D - 1 - q_next;
      if (q_next < NB ? q_next >= D && q_next - D >= done_down
                      : j + D < NB - done_up)
        break;
      if (q_next == NB) s_next = j % D;
      copy_in(ring + s_next * slot_elems, blocks + 3LL * j * WW, 3 * WW,
              &bars[s_next]);
      ++q_next;
      if (q_next < NB)
        s_next = s_next + 1 == D ? 0 : s_next + 1;
      else if (q_next > NB)
        s_next = s_next == 0 ? D - 1 : s_next - 1;
    }
  };
  auto wait_bar = [&](int i) {
    if (FAST) {
      if (producer) {
        while (!mbar_try_wait(&bars[i], (phase >> i) & 1u)) {
        }
        phase ^= 1u << i;
      }
    } else {
      __pipeline_wait_prior(0);
    }
  };
  // The end of a chunk of c blocks: free slots, copy ahead, wait for the
  // next chunk's blocks [j0, j0 + cn) (`up`: only those not kept from the
  // down-sweep), barrier. A chunk's
  // slots are freed at the end of the next chunk, after a barrier has
  // passed their last reads (the ring holds two chunks, D >= 2 cmax);
  // with one slot a barrier comes first.
  auto advance = [&](int& done, int c, int j0, int cn, bool up) {
    if (D > 1) {
      done += pend;
      pend = c;
    } else {
      __syncthreads();
      done += c;
    }
    issue();
    for (int j = j0, s = cn > 0 ? j0 % D : 0; j < j0 + cn; ++j) {
      if (!up || j < NB - D) wait_bar(s);
      s = s + 1 == D ? 0 : s + 1;
    }
    __syncthreads();
  };

  // the static level structure: blocks n, first odd block
  int lv_n[kMaxLevels], lv_off[kMaxLevels], nlev = 0;
  for (int n = K, off = 0; n > 1; n -= n / 2) {
    lv_n[nlev] = n;
    lv_off[nlev++] = off;
    off += n / 2;
  }

  if (fence) {
    fence_proxy_async();
    __syncthreads();
  }
  if (FAST && producer) {
    for (int i = 0; i < D; ++i) mbar_init(&bars[i], 1);
    mbar_init(&bars[D], 2);  // b and the root
    mbar_init_fence();
  }
  copy_in(cur, b, K * Wp, &bars[D]);
  copy_in(rt, root, WW, &bars[D]);
  // copy ahead; wait for b, the root and the first chunk's blocks
  issue();
  wait_bar(D);
  const int o0 = nlev > 0 ? lv_n[0] / 2 : 0;
  advance(done_down, 0, 0, o0 < cmax ? o0 : cmax, false);

  // ---- down-sweep ----
  for (int l = 0; l < nlev; ++l) {
    const int n = lv_n[l], o = n / 2, ne = n - o, off = lv_off[l];
    for (int a = 0; a < o; a += cmax) {
      const int c = o - a < cmax ? o - a : cmax;
      const int s0 = (off + a) % D;
      // S t_m = S L_m^{-1} b_{2m+1}, kept signed
      for (int i = tid; i < c * Wp; i += nt) {
        const int mm = i / Wp, r = i - mm * Wp;
        const int s = s0 + mm < D ? s0 + mm : s0 + mm - D;
        ts[(off + a + mm) * Wp + r] =
            sig<T>(r, p) *
            row(ring + s * slot_elems, cur + (2 * (a + mm) + 1) * Wp, r);
      }
      __syncthreads();
      // b_{2j} -= R_j' S t_j + Q_{j-1}' S t_{j-1} for the even blocks j
      // of [a, a + c]: block a + c gets only its Q term, kept in qs for
      // the next chunk (or applied, on the level's last even block)
      const int jn = (a + c < ne - 1 ? a + c : ne - 1) - a + 1;
      for (int i = tid; i < jn * Wp; i += nt) {
        const int mm = i / Wp, r = i - mm * Wp, j = a + mm;
        const int s = s0 + mm < D ? s0 + mm : s0 + mm - D;
        const int sp = s == 0 ? D - 1 : s - 1;  // block j - 1's slot
        const bool has_r = mm < c, has_q = mm > 0 || !has_r;
        const T accR =
            has_r ? col(ring + s * slot_elems + WW, ts + (off + j) * Wp, r)
                  : T(0);
        const T accQ = has_q ? col(ring + sp * slot_elems + 2 * WW,
                                   ts + (off + j - 1) * Wp, r)
                             : T(0);
        T v = cur[2 * j * Wp + r];
        if (has_r) {
          v -= accR;
          if (has_q)
            v -= accQ;
          else if (j >= 1)
            v -= qs[j * Wp + r];
          nxt[j * Wp + r] = v;
        } else if (j < o) {
          qs[j * Wp + r] = accQ;
        } else {
          nxt[j * Wp + r] = v - accQ;
        }
      }
      // the next chunk: of this level, of the next one, or none
      const int on = l + 1 < nlev ? lv_n[l + 1] / 2 : 0;
      const bool last = a + c >= o;
      advance(done_down, c, last ? (l + 1 < nlev ? lv_off[l + 1] : 0)
                                 : off + a + c,
              last ? (l + 1 < nlev ? (on < cmax ? on : cmax) : -1)
                   : (o - a - c < cmax ? o - a - c : cmax),
              false);
    }
    T* tmp = cur; cur = nxt; nxt = tmp;
  }

  // ---- root: x_0 = L^{-T} S L^{-1} b_0 ----
  for (int r = tid; r < Wp; r += nt) u[r] = sig<T>(r, p) * row(rt, cur, r);
  __syncthreads();
  for (int r = tid; r < Wp; r += nt) nxt[r] = col(rt, u, r);
  __syncthreads();
  { T* tmp = cur; cur = nxt; nxt = tmp; }

  // ---- up-sweep ----
  pend = 0;
  for (int l = nlev - 1; l >= 0; --l) {
    const int n = lv_n[l], o = n / 2, ne = n - o, off = lv_off[l];
    for (int hi = o; hi > 0;) {
      const int c = hi < cmax ? hi : cmax, a = hi - c;
      const int s0 = (off + a) % D;
      // S (t_m - R_m x_m - Q_m x_{m+1}), x_{m+1} = 0 past the last block
      for (int i = tid; i < c * Wp; i += nt) {
        const int mm = i / Wp, r = i - mm * Wp, m = a + mm;
        const int s = s0 + mm < D ? s0 + mm : s0 + mm - D;
        const T* F = ring + s * slot_elems;
        const T accR = row(F + WW, cur + m * Wp, r);
        const T accQ = m + 1 < ne ? row(F + 2 * WW, cur + (m + 1) * Wp, r)
                                  : T(0);
        const T sg = sig<T>(r, p);
        qs[m * Wp + r] = sg * (sg * ts[(off + m) * Wp + r] - accR - accQ);
      }
      __syncthreads();
      // x_{2m+1} = L_m^{-T} S rhs_m; the level's first chunk also copies
      // x_{2m} = x_m
      for (int i = tid; i < c * Wp; i += nt) {
        const int mm = i / Wp, r = i - mm * Wp, m = a + mm;
        const int s = s0 + mm < D ? s0 + mm : s0 + mm - D;
        nxt[(2 * m + 1) * Wp + r] = col(ring + s * slot_elems, qs + m * Wp, r);
      }
      if (hi == o)
        for (int i = tid; i < ne * Wp; i += nt)
          nxt[(i / Wp) * 2 * Wp + i % Wp] = cur[i];
      // the next chunk: of this level, of the one below, or none
      const int on = l > 0 ? lv_n[l - 1] / 2 : 0;
      const int cn = a > 0 ? (a < cmax ? a : cmax)
                           : (l > 0 ? (on < cmax ? on : cmax) : -1);
      advance(done_up, c,
              a > 0 ? off + a - cn : (l > 0 ? lv_off[l - 1] + on - cn : 0),
              cn, true);
      hi = a;
    }
    T* tmp = cur; cur = nxt; nxt = tmp;
  }

  for (int i = tid; i < K * Wp; i += nt) x[i] = cur[i];
  if (FAST && producer)
    for (int i = 0; i <= D; ++i) mbar_inval(&bars[i]);
}

// Solve with `budget` bytes of shared memory at `smem` (16-byte aligned;
// at least smem_bytes(K, Wp, 1, sizeof(T)): the launchers refuse a
// smaller budget, and the block traps on one).
// Every thread of the block calls it, after a barrier that ends every
// other use of `smem`; it ends with each thread's writes of x after its
// last barrier. `fence`: the block itself has just written the factor or
// b (global memory) or `smem`, and a proxy fence by every thread and a
// barrier order those writes before the bulk copies.
template <typename T>
__device__ __forceinline__ void solve(int K, int Wp, int p, const T* blocks,
                                      const T* root, const T* b, T* x,
                                      void* smem, long long budget,
                                      bool fence) {
  const int D = ring_slots(K, Wp, budget, sizeof(T));
  if (D < 1) __trap();
  const bool fast = (Wp * (int)sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<unsigned long long>(blocks) % 16 == 0 &&
                    reinterpret_cast<unsigned long long>(root) % 16 == 0 &&
                    reinterpret_cast<unsigned long long>(b) % 16 == 0;
  if (fast)
    solve_ring<T, true>(K, Wp, p, D, blocks, root, b, x, smem, fence);
  else
    solve_ring<T, false>(K, Wp, p, D, blocks, root, b, x, smem, fence);
}

}  // namespace cr
