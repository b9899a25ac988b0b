// Device bodies of the fused discretize and resim kernels (disc_mono.cu):
// fixed-step Runge-Kutta of every (scenario x interval) pair in
// normalized time tau in [0, 1] with the right-hand side scaled by the
// interval's dt, as the plain versions `_disc_plain` and `_resim_plain`
// in scpp_tpu_torch/ops/disc_mono.py compute it. See disc_mono.cu for the
// kernel entries, the launch shapes and what bounds them on the card.
//
// Everything here is plain C++ over a scalar type: under nvcc it is
// device code; on the host it compiles with g++ under host_shim.h (each
// CUDA thread a std::thread, __syncthreads a barrier), which is how the
// CPU tests check this arithmetic.
#pragma once

#include <math.h>

#include <type_traits>

namespace disc {

__host__ __device__ inline float dsqrt(float a) { return sqrtf(a); }
__host__ __device__ inline double dsqrt(double a) { return sqrt(a); }
__host__ __device__ inline float dabs(float a) { return fabsf(a); }
__host__ __device__ inline double dabs(double a) { return fabs(a); }

// ---------------------------------------------------------------------------
// Forward-mode dual number: a value and one tangent. Each operation's
// tangent follows the rule torch.func's jvp uses for it, so a flow map
// evaluated on Dual<T> seeded on input direction j gives f and column j of
// [df/dx | df/du], as the reference's jvp does (disc_mono.py
// _flow_jac_flat). Parameters enter as plain T (no tangent).

template <typename T>
struct Dual {
  T v, d;
  __host__ __device__ Dual() : v(0), d(0) {}
  __host__ __device__ Dual(T v_, T d_) : v(v_), d(d_) {}
};

template <typename T>
__host__ __device__ inline Dual<T> operator+(Dual<T> a, Dual<T> b) {
  return {a.v + b.v, a.d + b.d};
}
template <typename T>
__host__ __device__ inline Dual<T> operator+(Dual<T> a, T b) {
  return {a.v + b, a.d};
}
template <typename T>
__host__ __device__ inline Dual<T> operator-(Dual<T> a, Dual<T> b) {
  return {a.v - b.v, a.d - b.d};
}
template <typename T>
__host__ __device__ inline Dual<T> operator-(T a, Dual<T> b) {
  return {a - b.v, -b.d};
}
template <typename T>
__host__ __device__ inline Dual<T> operator-(Dual<T> a) {
  return {-a.v, -a.d};
}
template <typename T>
__host__ __device__ inline Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <typename T>
__host__ __device__ inline Dual<T> operator*(T a, Dual<T> b) {
  return {a * b.v, a * b.d};
}
template <typename T>
__host__ __device__ inline Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T v = a.v / b.v;
  return {v, (a.d - b.d * v) / b.v};
}
template <typename T>
__host__ __device__ inline Dual<T> operator/(Dual<T> a, T b) {
  return {a.v / b, a.d / b};
}
template <typename T>
__host__ __device__ inline Dual<T> dsqrt(Dual<T> a) {
  const T v = dsqrt(a.v);
  return {v, a.d / (T(2) * v)};
}

// ---------------------------------------------------------------------------
// Models: `flow(x, u, par, f)` over a scalar type S (T or Dual<T>), with
// the parameters as T.

// RocketQuat (scpp_tpu/models/rocket_quat.py flow_map; rocketQuat.cpp:7-37):
// the same expressions in the same order, the rotation matrix and the
// three small contractions written out component-wise as there.
struct RocketQuat {
  static constexpr int n = 14, m = 4, p = 10;

  template <typename S, typename T>
  __host__ __device__ static void flow(const S* x, const S* u, const T* par,
                                       S* f) {
    const T alpha_m = par[0];
    const T* g_I = par + 1;
    const T* J_B = par + 4;
    const T* r_T_B = par + 7;
    const S mass = x[0];
    const S qw = x[7], qx = x[8], qy = x[9], qz = x[10];
    const S w0 = x[11], w1 = x[12], w2 = x[13];
    const S t0 = u[0], t1 = u[1], t2 = u[2];
    const T one(1), two(2), half(0.5), zero(0);

    // quat_to_rotmat on the raw components (scpp_tpu/models/mathlib.py)
    const S R00 = one - two * (qy * qy + qz * qz);
    const S R01 = two * (qx * qy - qw * qz);
    const S R02 = two * (qx * qz + qw * qy);
    const S R10 = two * (qx * qy + qw * qz);
    const S R11 = one - two * (qx * qx + qz * qz);
    const S R12 = two * (qy * qz - qw * qx);
    const S R20 = two * (qx * qz - qw * qy);
    const S R21 = two * (qy * qz + qw * qx);
    const S R22 = one - two * (qx * qx + qy * qy);

    f[0] = (-alpha_m) * dsqrt(t0 * t0 + t1 * t1 + t2 * t2);
    f[1] = x[4];
    f[2] = x[5];
    f[3] = x[6];
    f[4] = (R00 * t0 + R01 * t1 + R02 * t2) / mass + g_I[0];
    f[5] = (R10 * t0 + R11 * t1 + R12 * t2) / mass + g_I[1];
    f[6] = (R20 * t0 + R21 * t1 + R22 * t2) / mass + g_I[2];
    f[7] = half * ((-w0) * qx - w1 * qy - w2 * qz);
    f[8] = half * (w0 * qw + w2 * qy - w1 * qz);
    f[9] = half * (w1 * qw - w2 * qx + w0 * qz);
    f[10] = half * (w2 * qw + w1 * qx - w0 * qy);
    f[11] = (r_T_B[1] * t2 - r_T_B[2] * t1 + zero) / J_B[0];
    f[12] = (r_T_B[2] * t0 - r_T_B[0] * t2 + zero) / J_B[1];
    f[13] = (r_T_B[0] * t1 - r_T_B[1] * t0 + u[3]) / J_B[2];
  }
};

// ---------------------------------------------------------------------------
// Butcher tableaus, the values of scpp_tpu_torch/ops/integrators.TABLEAUS
// (each entry the same correctly rounded double). `used(i)`: stage i's
// slope is read by a later stage or by the final combination; dopri5's
// last (FSAL) stage has weight 0 and no reader, so it is not evaluated.

struct Rk4 {
  static constexpr int S = 4;
  __host__ __device__ static constexpr double c(int i) {
    return i == 0 ? 0.0 : i == 3 ? 1.0 : 0.5;
  }
  __host__ __device__ static constexpr double a(int i, int j) {
    return (i == 1 && j == 0) || (i == 2 && j == 1) ? 0.5
           : (i == 3 && j == 2)                     ? 1.0
                                                    : 0.0;
  }
  __host__ __device__ static constexpr double b(int i) {
    return i == 0 || i == 3 ? 1.0 / 6 : 1.0 / 3;
  }
};

struct Dopri5 {
  static constexpr int S = 7;
  __host__ __device__ static constexpr double c(int i) {
    return i == 0 ? 0.0 : i == 1 ? 1.0 / 5 : i == 2 ? 3.0 / 10
           : i == 3 ? 4.0 / 5 : i == 4 ? 8.0 / 9 : 1.0;
  }
  __host__ __device__ static constexpr double a(int i, int j) {
    switch (i * 8 + j) {
      case 8: return 1.0 / 5;
      case 16: return 3.0 / 40;
      case 17: return 9.0 / 40;
      case 24: return 44.0 / 45;
      case 25: return -56.0 / 15;
      case 26: return 32.0 / 9;
      case 32: return 19372.0 / 6561;
      case 33: return -25360.0 / 2187;
      case 34: return 64448.0 / 6561;
      case 35: return -212.0 / 729;
      case 40: return 9017.0 / 3168;
      case 41: return -355.0 / 33;
      case 42: return 46732.0 / 5247;
      case 43: return 49.0 / 176;
      case 44: return -5103.0 / 18656;
      case 48: return 35.0 / 384;
      case 49: return 0.0;
      case 50: return 500.0 / 1113;
      case 51: return 125.0 / 192;
      case 52: return -2187.0 / 6784;
      case 53: return 11.0 / 84;
      default: return 0.0;
    }
  }
  __host__ __device__ static constexpr double b(int i) {
    return i == 6 ? 0.0 : a(6, i);
  }
};

template <class Tab>
__host__ __device__ constexpr bool used(int i) {
  return Tab::b(i) != 0.0 || i < Tab::S - 1;
}

// Slope sums in the order of integrators.rk_step: the stage input
// y + sum_{j<i} (h a_ij) k_j over every j (zero coefficients included, as
// there), the step y + sum_i (h b_i) k_i over the nonzero weights only.
template <class Tab, int R, typename T>
__host__ __device__ inline void stage_input(const T (&y)[R],
                                            const T (&k)[Tab::S][R], int i,
                                            double h, T (&yi)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) yi[r] = y[r];
#pragma unroll
  for (int j = 0; j < Tab::S - 1; ++j) {
    if (j < i) {
      const T coef = T(h * Tab::a(i, j));
#pragma unroll
      for (int r = 0; r < R; ++r) yi[r] = yi[r] + coef * k[j][r];
    }
  }
}

template <class Tab, int R, typename T>
__host__ __device__ inline void step_update(T (&y)[R],
                                            const T (&k)[Tab::S][R],
                                            double h) {
#pragma unroll
  for (int i = 0; i < Tab::S; ++i) {
    if (Tab::b(i) != 0.0) {
      const T coef = T(h * Tab::b(i));
#pragma unroll
      for (int r = 0; r < R; ++r) y[r] = y[r] + coef * k[i][r];
    }
  }
}

// ---------------------------------------------------------------------------
// Discretize: one interval per 32-thread block.
//
// The augmented state is [x | Y], Y = [Phi | Y_B | (Y_C) | y_z] (n rows,
// ncols columns), integrated under
//   x' = dt f(x, u(tau)),
//   Y' = dt (A Y + [0 | B (1 - tau) | B tau | f - A x - B u])   (FOH)
//   Y' = dt (A Y + [0 | B | f - A x - B u])                      (ZOH)
// Thread c < ncols owns column c of Y, thread ncols owns x: each keeps its
// n values and its stage slopes in registers. Per stage, thread j < n + m
// evaluates the flow map on dual numbers seeded on input direction j and
// writes column j of [A | B] to shared memory (thread 0 also writes f);
// threads i < n form r_i = f_i - (A x)_i - (B u)_i; then every column
// thread takes its slope A y_c + R_c. Three barriers per stage.

template <class Model, bool FOH>
struct DiscShape {
  static constexpr int n = Model::n, m = Model::m, nm = n + m;
  static constexpr int ncols = n + m + (FOH ? m : 0) + 1;
  static constexpr int xlane = ncols;
  static_assert(nm <= 32 && ncols + 1 <= 32,
                "one 32-thread block per interval");
};

template <class Model>
__host__ __device__ constexpr int disc_smem_elems() {
  // x stage, [A | B], f, r
  return Model::n + Model::n * (Model::n + Model::m) + 2 * Model::n;
}

// Interval `iv` of B * (K - 1): X (B, K, n), U (B, KU, m) with KU = K
// (FOH) or K - 1 (ZOH), t (B,), par (B, p); A (B, K-1, n, n),
// Bm and C (B, K-1, n, m), z (B, K-1, n).
template <class Model, class Tab, bool FOH, typename T>
__device__ void disc_block(long long iv, int tid, int K, int KU,
                                    int substeps, const T* X, const T* U,
                                    const T* ts, const T* par, T* A, T* Bm,
                                    T* C, T* z, T* smem) {
  using Sh = DiscShape<Model, FOH>;
  constexpr int n = Sh::n, m = Sh::m, nm = Sh::nm, ncols = Sh::ncols;
  const long long b = iv / (K - 1);
  const int k = (int)(iv % (K - 1));
  const T* xk = X + (b * K + k) * n;
  const T* u0g = U + (b * KU + k) * m;
  const T* u1g = FOH ? u0g + m : u0g;
  const T* pb = par + b * Model::p;
  const T dt = ts[b] / T(K - 1);

  T* xs = smem;           // stage state (n)
  T* J = xs + n;          // [A | B] (n, nm)
  T* fs = J + n * nm;     // f (n)
  T* rs = fs + n;         // f - A x - B u (n)

  T u0[m], du[m];
#pragma unroll
  for (int j = 0; j < m; ++j) {
    u0[j] = u0g[j];
    du[j] = u1g[j] - u0g[j];
  }
  T y[n], yi[n], kk[Tab::S][n];
#pragma unroll
  for (int r = 0; r < n; ++r) {
    y[r] = tid == Sh::xlane ? xk[r] : T(tid == r ? 1 : 0);
    yi[r] = T(0);
  }
  const double h = 1.0 / substeps;
  for (int s = 0; s < substeps; ++s) {
    const double t0 = s * h;
#pragma unroll
    for (int i = 0; i < Tab::S; ++i) {
      if (!used<Tab>(i)) continue;
      const double tau = t0 + Tab::c(i) * h;
      stage_input<Tab>(y, kk, i, h, yi);
      if (tid == Sh::xlane) {
#pragma unroll
        for (int r = 0; r < n; ++r) xs[r] = yi[r];
      }
      __syncthreads();
      T u[m];
#pragma unroll
      for (int j = 0; j < m; ++j)
        u[j] = FOH ? u0[j] + T(tau) * du[j] : u0[j];
      if (tid < nm) {
        Dual<T> xd[n], ud[m], fd[n];
#pragma unroll
        for (int r = 0; r < n; ++r) xd[r] = Dual<T>(xs[r], T(r == tid));
#pragma unroll
        for (int j = 0; j < m; ++j) ud[j] = Dual<T>(u[j], T(n + j == tid));
        Model::flow(xd, ud, pb, fd);
#pragma unroll
        for (int r = 0; r < n; ++r) J[r * nm + tid] = fd[r].d;
        if (tid == 0) {
#pragma unroll
          for (int r = 0; r < n; ++r) fs[r] = fd[r].v;
        }
      }
      __syncthreads();
      if (tid < n) {
        const T* Ar = J + tid * nm;
        T ax = T(0), bu = T(0);
        for (int c = 0; c < n; ++c) ax = ax + Ar[c] * xs[c];
#pragma unroll
        for (int j = 0; j < m; ++j) bu = bu + Ar[n + j] * u[j];
        rs[tid] = fs[tid] - ax - bu;
      }
      __syncthreads();
      if (tid < ncols) {
        // R's column `tid`: zero under Phi, then B (1 - tau) | B tau (FOH)
        // or B (ZOH), then r
        const int c = tid;
        const T w1 = FOH ? T(1.0 - tau) : T(1), w2 = T(tau);
#pragma unroll
        for (int r = 0; r < n; ++r) {
          const T* Ar = J + r * nm;
          T acc = T(0);
          for (int q = 0; q < n; ++q) acc = acc + Ar[q] * yi[q];
          T Rc = T(0);
          if (c == ncols - 1)
            Rc = rs[r];
          else if (c >= n && c < n + m)
            Rc = Ar[c] * w1;
          else if (c >= n + m)
            Rc = Ar[c - m] * w2;
          kk[i][r] = dt * (acc + Rc);
        }
      } else if (tid == Sh::xlane) {
#pragma unroll
        for (int r = 0; r < n; ++r) kk[i][r] = dt * fs[r];
      }
    }
    step_update<Tab>(y, kk, h);
  }
  if (tid < ncols) {
    const int c = tid;
    const long long o = iv;
#pragma unroll
    for (int r = 0; r < n; ++r) {
      if (c < n)
        A[(o * n + r) * n + c] = y[r];
      else if (c < n + m)
        Bm[(o * n + r) * m + (c - n)] = y[r];
      else if (FOH && c < n + 2 * m)
        C[(o * n + r) * m + (c - n - m)] = y[r];
      else
        z[o * n + r] = y[r];
    }
  }
}

// ---------------------------------------------------------------------------
// Resim: one scenario per block, one interval per thread. Each thread
// propagates its interval's start state over the interval and sums
// |x_end - x_{k+1}| over the state (in state order) into shared memory;
// thread 0 then adds the intervals' sums in interval order. No atomics:
// the result does not depend on the launch.

template <class Model, class Tab, bool FOH, typename T>
__device__ T resim_interval(int substeps, const T* xk,
                                     const T* xnext, const T* u0g,
                                     const T* u1g, const T* pb, T dt) {
  constexpr int n = Model::n, m = Model::m;
  T u0[m], du[m];
#pragma unroll
  for (int j = 0; j < m; ++j) {
    u0[j] = u0g[j];
    du[j] = u1g[j] - u0g[j];
  }
  T y[n], yi[n], kk[Tab::S][n], f[n];
#pragma unroll
  for (int r = 0; r < n; ++r) y[r] = xk[r];
  const double h = 1.0 / substeps;
  for (int s = 0; s < substeps; ++s) {
    const double t0 = s * h;
#pragma unroll
    for (int i = 0; i < Tab::S; ++i) {
      if (!used<Tab>(i)) continue;
      const double tau = t0 + Tab::c(i) * h;
      stage_input<Tab>(y, kk, i, h, yi);
      T u[m];
#pragma unroll
      for (int j = 0; j < m; ++j)
        u[j] = FOH ? u0[j] + T(tau) * du[j] : u0[j];
      Model::flow(yi, u, pb, f);
#pragma unroll
      for (int r = 0; r < n; ++r) kk[i][r] = dt * f[r];
    }
    step_update<Tab>(y, kk, h);
  }
  T d = T(0);
#pragma unroll
  for (int r = 0; r < n; ++r) d = d + dabs(y[r] - xnext[r]);
  return d;
}

// Scenario `b`: J[b] = sum_k sum_i |x_end(k)_i - X[b, k+1, i]|. `red`
// holds K - 1 values.
template <class Model, class Tab, bool FOH, typename T>
__device__ void resim_block(long long b, int tid, int nthreads,
                                     int K, int KU, int substeps, const T* X,
                                     const T* U, const T* ts, const T* par,
                                     T* Jout, T* red) {
  constexpr int n = Model::n, m = Model::m;
  const T dt = ts[b] / T(K - 1);
  const T* pb = par + b * Model::p;
  for (int k = tid; k < K - 1; k += nthreads) {
    const T* xk = X + (b * K + k) * n;
    const T* u0g = U + (b * KU + k) * m;
    red[k] = resim_interval<Model, Tab, FOH>(substeps, xk, xk + n, u0g,
                                             FOH ? u0g + m : u0g, pb, dt);
  }
  __syncthreads();
  if (tid == 0) {
    T J = T(0);
    for (int k = 0; k < K - 1; ++k) J = J + red[k];
    Jout[b] = J;
  }
}

// ---------------------------------------------------------------------------
// Variant dispatch, shared by the kernel entries and the host build:
// calls f(Model{}, Tab{}, std::integral_constant<bool, FOH>{}, T{}) for
// the runtime choice, or returns `bad` for one it does not take.
// model 0 = RocketQuat; method 0 = rk4, 1 = dopri5; elem_bytes 4 or 8.

template <class Model, class Tab, typename T, class F>
int with_foh(int foh, F&& f) {
  return foh ? f(Model{}, Tab{}, std::true_type{}, T{})
             : f(Model{}, Tab{}, std::false_type{}, T{});
}

template <class Model, typename T, class F>
int with_method(int method, int foh, int bad, F&& f) {
  if (method == 0) return with_foh<Model, Rk4, T>(foh, f);
  if (method == 1) return with_foh<Model, Dopri5, T>(foh, f);
  return bad;
}

template <class F>
int dispatch(int elem_bytes, int model, int method, int foh, int bad,
             F&& f) {
  if (model != 0) return bad;
  if (elem_bytes == 4) return with_method<RocketQuat, float>(method, foh, bad, f);
  if (elem_bytes == 8) return with_method<RocketQuat, double>(method, foh, bad, f);
  return bad;
}

}  // namespace disc
