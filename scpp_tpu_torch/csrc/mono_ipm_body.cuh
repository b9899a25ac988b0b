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
// Every loop below is block-strided over threads and every phase ends in
// __syncthreads(); scalars of the scenario come from block reductions, so
// all control flow is uniform across the block.
#pragma once

#include <math.h>

namespace mono {

constexpr int kMaxSoc = 32;
constexpr int kPanel = 8;   // the reference's Cholesky panel width

struct Dims {
  int K, w, me, l, S, mc, Wp;
  int soc_off[kMaxSoc];
  int soc_q[kMaxSoc];
  int iters, refine_steps, track_best;
  int part;  // -1 whole solve, -2 initialization only, N >= 0 iterations
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

// Element counts of the per-scenario global workspace and of the dynamic
// shared memory, shared by the kernel and the host wrapper.
__host__ __device__ inline long long workspace_elems(int K, int w, int me,
                                                     int mc) {
  const long long Wp = w + me;
  const long long nw = (long long)K * w, ne = (long long)K * me,
                  nc = (long long)K * mc;
  return K * Wp * Wp            // Linv_k
         + (K - 1) * Wp * w     // P_k (only the first w columns are nonzero)
         + K * Wp               // forward-sweep values t_k
         + 19 * nc + 10 * nw + 10 * ne;
}

__host__ __device__ inline long long smem_elems(int w, int me, int mc,
                                               int threads) {
  const long long Wp = w + me;
  return 2LL * w * mc + 2 * Wp * Wp + Wp * w + 3LL * w * w + 4 * Wp +
         threads;
}

template <typename T>
struct Solver {
  const Dims& P;
  int K, w, me, mc, l, S, Wp, U, tid, nt;
  // inputs of this scenario
  const T *AT, *GT, *beq, *h, *c, *deq, *dc, *Est;
  // factor storage (global)
  T *Linv, *Pf, *Tst;
  // iterate state and temporaries (global)
  T *x, *y, *s, *z, *bx, *by, *bs, *bz;
  T *rx, *ry, *rz, *rd, *ru, *rdet, *lam, *idd, *idu, *iddet;
  T *dx, *dy, *dz, *ds, *c1, *c2, *w1, *w2, *e1, *e2;
  // kkt_solve scratch (global)
  T *u3, *sy, *sz, *r1, *ax, *gx, *mx, *rr1, *ff2, *cx, *cy;
  // shared
  T *gw, *bufD, *bufL, *Pm, *hA, *hB, *hxn, *vec, *vec2, *carry, *xn, *red;

  __device__ Solver(const Dims& dims, T* smem, T* work, const T* AT_,
                    const T* GT_, const T* beq_, const T* h_, const T* c_,
                    const T* deq_, const T* dc_, const T* Est_)
      : P(dims) {
    K = P.K; w = P.w; me = P.me; mc = P.mc; l = P.l; S = P.S; Wp = P.Wp;
    U = l + S;
    tid = threadIdx.x;
    nt = blockDim.x;
    AT = AT_; GT = GT_; beq = beq_; h = h_; c = c_; deq = deq_; dc = dc_;
    Est = Est_;
    const int nw = K * w, ne = K * me, nc = K * mc;
    T* p = work;
    Linv = p; p += (long long)K * Wp * Wp;
    Pf = p; p += (long long)(K - 1) * Wp * w;
    Tst = p; p += K * Wp;
    T** cvecs[] = {&s, &z, &bs, &bz, &rz, &rd, &ru, &rdet, &lam, &idd, &idu,
                   &iddet, &dz, &ds, &c1, &c2, &u3, &sz, &gx};
    for (T** v : cvecs) { *v = p; p += nc; }
    T** wvecs[] = {&x, &bx, &rx, &dx, &w1, &w2, &r1, &mx, &rr1, &cx};
    for (T** v : wvecs) { *v = p; p += nw; }
    T** evecs[] = {&y, &by, &ry, &dy, &e1, &e2, &sy, &ax, &ff2, &cy};
    for (T** v : evecs) { *v = p; p += ne; }
    T* sp = smem;
    gw = sp; sp += 2 * w * mc;
    bufD = sp; sp += Wp * Wp;
    bufL = sp; sp += Wp * Wp;
    Pm = sp; sp += Wp * w;
    hA = sp; sp += w * w;
    hB = sp; sp += w * w;
    hxn = sp; sp += w * w;
    vec = sp; sp += Wp;
    vec2 = sp; sp += Wp;
    carry = sp; sp += Wp;
    xn = sp; sp += Wp;
    red = sp;
  }

  __device__ __forceinline__ void sync() { __syncthreads(); }

  // ---- block reductions (blockDim.x is a power of two) ----

  template <typename Op>
  __device__ T reduce(T v, Op op) {
    red[tid] = v;
    sync();
    for (int st = nt / 2; st > 0; st >>= 1) {
      if (tid < st) red[tid] = op(red[tid], red[tid + st]);
      sync();
    }
    const T r = red[0];
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
    for (int m = 0; m < me; ++m) s1 += a[m] * yv[k * me + m];
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
  __device__ void apply_Winv(const T* d, const T* uu, const T* det,
                             const T* v, T* out) {
    for (int i = tid; i < K * U; i += nt) {
      const int k = i / U, u = i % U;
      int off, q;
      unit(u, off, q);
      const int b = k * mc + off;
      winv_cone(u < l, q, d + b, uu + b, det + b, v + b, out + b);
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

  // ---- KKT: sequential signed block-LDL^T over the stages ----
  //
  // Stage block D_k (Wp x Wp) = [[eps I + Hxx_k + Hnn_{k-1}, Axy_k],
  // [Axy_k^T, -delta I]] with Gam = GwT GwT^T + rho AT AT^T, coupling
  // O_k = M[k+1, k] = [[Hxn_k, AT_k[w:, :]], [0, 0]]. Factor
  // D'_k = L_k S L_k^T (S = +1 on the w primal columns, -1 on the me dual
  // ones), P_k = L_k^{-1} O_k^T, D'_{k+1} = D_{k+1} - P_k^T S P_k.

  __device__ void factor(const T* d, const T* uu, const T* det) {
    const T eps = T(P.eps_reg), rho = T(P.rho);
    T* hprev = hA;
    T* hcur = hB;
    for (int k = 0; k < K; ++k) {
      const T* GTk = GT + (long long)k * 2 * w * mc;
      const T* ATk = AT + (long long)k * 2 * w * me;
      // rows of W^{-1} G_k^T (the scaling applied along the cone axis)
      for (int i = tid; i < 2 * w * U; i += nt) {
        const int r = i / U, u = i % U;
        int off, q;
        unit(u, off, q);
        const int b = k * mc + off;
        winv_cone(u < l, q, d + b, uu + b, det + b, GTk + r * mc + off,
                  gw + r * mc + off);
      }
      sync();
      // Gram blocks: Hxx into D, Hnn kept for stage k+1, Hxn for O_k
      for (int i = tid; i < 3 * w * w; i += nt) {
        const int blk = i / (w * w), a = (i % (w * w)) / w, bb = i % w;
        const int ra = blk == 0 ? a : w + a;
        const int rb = blk == 1 ? w + bb : bb;
        T g1 = 0, g2 = 0;
        for (int j = 0; j < mc; ++j) g1 += gw[ra * mc + j] * gw[rb * mc + j];
        for (int m = 0; m < me; ++m) g2 += ATk[ra * me + m] * ATk[rb * me + m];
        const T gam = g1 + rho * g2;
        if (blk == 0) {
          T dv = (a == bb ? eps : T(0)) + gam;
          if (k > 0) {
            dv += hprev[a * w + bb];
            T pp = 0;
            for (int t = 0; t < Wp; ++t)
              pp += (t < w ? T(1) : T(-1)) * Pm[t * w + a] * Pm[t * w + bb];
            dv -= pp;
          }
          bufD[a * Wp + bb] = dv;
        } else if (blk == 1) {
          hcur[a * w + bb] = gam;
        } else {
          hxn[a * w + bb] = gam;
        }
      }
      for (int i = tid; i < Wp * Wp; i += nt) {
        const int r = i / Wp, cc = i % Wp;
        if (r < w && cc < w) continue;
        T v;
        if (r < w) v = ATk[r * me + cc - w];
        else if (cc < w) v = ATk[cc * me + r - w];
        else v = r == cc ? -T(P.eps_reg) : T(0);
        bufD[i] = v;
      }
      sync();
      chol_inv();
      T* Lk = Linv + (long long)k * Wp * Wp;
      for (int i = tid; i < Wp * Wp; i += nt) Lk[i] = bufD[i];
      if (k + 1 < K) {
        // P_k = Linv_k O_k^T, only its first w columns are nonzero
        T* Pk = Pf + (long long)k * Wp * w;
        for (int i = tid; i < Wp * w; i += nt) {
          const int r = i / w, j = i % w;
          T acc = 0;
          for (int t = 0; t <= r; ++t) {
            const T o = t < w ? hxn[j * w + t] : ATk[(w + j) * me + t - w];
            acc += bufD[r * Wp + t] * o;
          }
          Pm[i] = acc;
          Pk[i] = acc;
        }
      }
      sync();
      T* tmp = hprev; hprev = hcur; hcur = tmp;
    }
  }

  // bufD (lower triangle) -> signed Cholesky L in bufL -> L^{-1} in bufD,
  // as the reference's signed_chol_inv (scpp_tpu/solver/mono_blocks.py)
  // factors a block: in 8-column panels, every pivot floored at 1e-30.
  // Column j has t_j = max(s_j D_jj, 1e-30) and divides the rows of its
  // own panel by sqrt(t_j), the rows below that panel by
  // L_jj = s_j D_jj / sqrt(t_j). Without a floored pivot that is the
  // ordinary factor. A factor that overflows is NaN as a whole, as the
  // reference's panel products make it (see solver/mono_blocks.py).
  __device__ void chol_inv() {
    const int n = Wp;
    for (int j = 0; j < n; ++j) {
      const T sg = j < w ? T(1) : T(-1);
      const T d = sg * bufD[j * n + j];
      const T rt = sqrt(floored(d)), ljj = d / rt;
      const int own = (j / kPanel + 1) * kPanel;
      for (int i = tid; i < n * n; i += nt) {
        const int r = i / n, cc = i % n;
        if (r > j && cc > j && cc <= r)
          bufD[i] -= sg * bufD[r * n + j] * bufD[cc * n + j] /
                     ((r < own ? rt : ljj) * (cc < own ? rt : ljj));
      }
      sync();
    }
    T overflow = 0;                       // NaN iff an entry of L is not finite
    for (int i = tid; i < n * n; i += nt) {
      const int r = i / n, cc = i % n;
      T v = 0;
      if (r >= cc) {
        const T sg = cc < w ? T(1) : T(-1);
        const T d = sg * bufD[cc * n + cc];
        const T rt = sqrt(floored(d));
        v = sg * bufD[i] / (r < (cc / kPanel + 1) * kPanel ? rt : d / rt);
      }
      bufL[i] = v;
      overflow += v * T(0);
    }
    overflow = sum(overflow);
    // one thread per column of L^{-1}: forward substitution
    for (int cc = tid; cc < n; cc += nt) {
      for (int r = 0; r < cc; ++r) bufD[r * n + cc] = 0;
      bufD[cc * n + cc] = T(1) / bufL[cc * n + cc];
      for (int r = cc + 1; r < n; ++r) {
        T acc = 0;
        for (int t = cc; t < r; ++t) acc += bufL[r * n + t] * bufD[t * n + cc];
        bufD[r * n + cc] = -acc / bufL[r * n + r];
      }
    }
    sync();
    if (overflow != overflow) {
      for (int i = tid; i < n * n; i += nt) bufD[i] = T(NAN);
      sync();
    }
  }

  // solve M [ox; oy] = [rx_; ry_] with the stored factor
  __device__ void raw_solve(const T* rxv, const T* ryv, T* ox, T* oy) {
    for (int k = 0; k < K; ++k) {
      for (int i = tid; i < Wp; i += nt)
        vec[i] = i < w ? rxv[k * w + i] - (k > 0 ? carry[i] : T(0))
                       : ryv[k * me + i - w];
      sync();
      const T* Li = Linv + (long long)k * Wp * Wp;
      for (int i = tid; i < Wp; i += nt) {
        T acc = 0;
        for (int j = 0; j <= i; ++j) acc += Li[i * Wp + j] * vec[j];
        Tst[k * Wp + i] = acc;
      }
      sync();
      if (k + 1 < K) {
        const T* Pk = Pf + (long long)k * Wp * w;
        for (int a = tid; a < w; a += nt) {
          T acc = 0;
          for (int i = 0; i < Wp; ++i)
            acc += Pk[i * w + a] * ((i < w ? T(1) : T(-1)) * Tst[k * Wp + i]);
          carry[a] = acc;
        }
        sync();
      }
    }
    for (int k = K - 1; k >= 0; --k) {
      const T* Li = Linv + (long long)k * Wp * Wp;
      for (int i = tid; i < Wp; i += nt) {
        T g = Tst[k * Wp + i];
        if (k + 1 < K) {
          const T* Pk = Pf + (long long)k * Wp * w;
          T acc = 0;
          for (int a = 0; a < w; ++a) acc += Pk[i * w + a] * xn[a];
          g -= acc;
        }
        vec[i] = i < w ? g : -g;
      }
      sync();
      for (int j = tid; j < Wp; j += nt) {
        T acc = 0;
        for (int i = j; i < Wp; ++i) acc += Li[i * Wp + j] * vec[i];
        vec2[j] = acc;
      }
      sync();
      for (int j = tid; j < Wp; j += nt) {
        if (j < w) { ox[k * w + j] = vec2[j]; xn[j] = vec2[j]; }
        else oy[k * me + j - w] = vec2[j];
      }
      sync();
    }
  }

  // Newton direction for right-hand sides (f1, f2, rzWd) under a rep
  __device__ void kkt_solve(const T* d, const T* uu, const T* det,
                            const T* f1, const T* f2, const T* rzWd,
                            int refine, T* odx, T* ody, T* odz) {
    const int nw = K * w, ne = K * me, nc = K * mc;
    const T rho = T(P.rho);
    apply_Winv(d, uu, det, rzWd, u3);
    apply_Winv(d, uu, det, u3, u3);
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
      apply_Winv(d, uu, det, gx, gx);
      apply_Winv(d, uu, det, gx, gx);
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
    G_mv(odx, gx);
    apply_Winv(d, uu, det, gx, gx);
    apply_Winv(d, uu, det, gx, gx);
    for (int i = tid; i < nc; i += nt) odz[i] = gx[i] + u3[i];
    sync();
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
                      T* ox, T* oy, T* os, T* oz, T* odiag) {
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
      return;
    }

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
      nt_scaling(s, z);
      factor(rd, ru, rdet);
      // predictor (affine) direction
      for (int i = tid; i < nw; i += nt) w1[i] = -rx[i];
      for (int i = tid; i < ne; i += nt) e1[i] = -ry[i];
      for (int i = tid; i < nc; i += nt) c1[i] = rz[i] - s[i];
      sync();
      kkt_solve(rd, ru, rdet, w1, e1, c1, P.refine_steps, dx, dy, dz);
      G_mv(dx, ds);
      for (int i = tid; i < nc; i += nt) ds[i] = -ds[i] - rz[i];
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
      kkt_solve(rd, ru, rdet, w1, e1, c1, P.refine_steps, dx, dy, dz);
      G_mv(dx, ds);
      for (int i = tid; i < nc; i += nt) ds[i] = -ds[i] - rz[i];
      sync();
      const T a_sz = jmin(max_step(s, ds), max_step(z, dz));
      const T alpha = jmin(T(1), T(P.step_frac) * a_sz);
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
  }
};

}  // namespace mono
