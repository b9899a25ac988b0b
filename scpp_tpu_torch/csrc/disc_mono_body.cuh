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

// a / b, correctly rounded as `/` rounds it, without the device's slow
// path for a zero numerator, which the tangents of dual numbers meet all
// the time (a direction that does not reach an output): for a finite
// nonzero b, 0 / b is the zero of sign(a) xor sign(b), and so is a * b
#ifdef __CUDA_ARCH__
__device__ inline float tdiv(float a, float b) {
  const bool z = a == 0.f && fabsf(b) < INFINITY && b != 0.f;
  const float q = __fdiv_rn(z ? 1.f : a, b);
  return z ? __fmul_rn(a, b) : q;
}
__device__ inline double tdiv(double a, double b) {
  const bool z = a == 0.0 && fabs(b) < INFINITY && b != 0.0;
  const double q = __ddiv_rn(z ? 1.0 : a, b);
  return z ? __dmul_rn(a, b) : q;
}
#else
template <typename T>
inline T tdiv(T a, T b) {
  return a / b;
}
#endif

// ---------------------------------------------------------------------------
// Forward-mode dual numbers: a value and K tangents. Each operation's
// tangents follow the rule torch.func's jvp uses for it, so a flow map
// evaluated on Dual<T, K> seeded on K input directions gives f and those
// K columns of [df/dx | df/du], as the reference's jvp does (disc_mono.py
// _flow_jac_flat), each tangent bit for bit what it would be alone; the
// value is computed once. Parameters enter as plain T (no tangent).

template <typename T, int K>
struct Dual {
  T v, d[K];
};
template <typename T, int K>
__host__ __device__ inline Dual<T, K> operator+(Dual<T, K> a,
                                                 Dual<T, K> b) {
  Dual<T, K> o;
  o.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) o.d[k] = a.d[k] + b.d[k];
  return o;
}
template <typename T, int K>
__host__ __device__ inline Dual<T, K> operator+(Dual<T, K> a, T b) {
  a.v = a.v + b;
  return a;
}
template <typename T, int K>
__host__ __device__ inline Dual<T, K> operator-(Dual<T, K> a,
                                                 Dual<T, K> b) {
  Dual<T, K> o;
  o.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) o.d[k] = a.d[k] - b.d[k];
  return o;
}
template <typename T, int K>
__host__ __device__ inline Dual<T, K> operator-(T a, Dual<T, K> b) {
  Dual<T, K> o;
  o.v = a - b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) o.d[k] = -b.d[k];
  return o;
}
template <typename T, int K>
__host__ __device__ inline Dual<T, K> operator-(Dual<T, K> a) {
  Dual<T, K> o;
  o.v = -a.v;
#pragma unroll
  for (int k = 0; k < K; ++k) o.d[k] = -a.d[k];
  return o;
}
template <typename T, int K>
__host__ __device__ inline Dual<T, K> operator*(Dual<T, K> a,
                                                 Dual<T, K> b) {
  Dual<T, K> o;
  o.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) o.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return o;
}
template <typename T, int K>
__host__ __device__ inline Dual<T, K> operator*(T a, Dual<T, K> b) {
  Dual<T, K> o;
  o.v = a * b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) o.d[k] = a * b.d[k];
  return o;
}
template <typename T, int K>
__host__ __device__ inline Dual<T, K> operator/(Dual<T, K> a,
                                                 Dual<T, K> b) {
  Dual<T, K> o;
  o.v = a.v / b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) o.d[k] = tdiv(a.d[k] - b.d[k] * o.v, b.v);
  return o;
}
template <typename T, int K>
__host__ __device__ inline Dual<T, K> operator/(Dual<T, K> a, T b) {
  Dual<T, K> o;
  o.v = a.v / b;
#pragma unroll
  for (int k = 0; k < K; ++k) o.d[k] = tdiv(a.d[k], b);
  return o;
}
template <typename T, int K>
__host__ __device__ inline Dual<T, K> dsqrt(Dual<T, K> a) {
  Dual<T, K> o;
  o.v = dsqrt(a.v);
#pragma unroll
  for (int k = 0; k < K; ++k) o.d[k] = tdiv(a.d[k], T(2) * o.v);
  return o;
}

// ---------------------------------------------------------------------------
// Models: `flow(x, u, par, f)` over a scalar type S (T or Dual<T, K>),
// with the parameters as T; and a row at a time on T, by the same
// expressions (divisions by tdiv), for a thread that owns row r:
// `row_u(r, u, par)` for a row that does not read x (`reads_x(r)` false),
// `row_x(r, x, u, par)` for the others (x anything indexed as x[i]).
// A row alone may compile to other fused multiply-adds than in the whole
// map, so the two agree to an ulp or so on the card (bit for bit on the
// host, which fuses none).

// RocketQuat (scpp_tpu/models/rocket_quat.py flow_map; rocketQuat.cpp:7-37):
// the same expressions in the same order, the rotation matrix and the
// three small contractions written out component-wise as there. Rows 0
// (the mass rate) and 11-13 (the angular acceleration) read u alone.
struct RocketQuat {
  static constexpr int n = 14, m = 4, p = 10;
  __host__ __device__ static constexpr bool reads_x(int r) {
    return r >= 1 && r <= 10;
  }
  // entry (a, c) of quat_to_rotmat on the raw components
  // (scpp_tpu/models/mathlib.py)
  template <typename T>
  __host__ __device__ static T rot(int a, int c, T qw, T qx, T qy, T qz) {
    const T one(1), two(2);
    switch (3 * a + c) {
      case 0: return one - two * (qy * qy + qz * qz);
      case 1: return two * (qx * qy - qw * qz);
      case 2: return two * (qx * qz + qw * qy);
      case 3: return two * (qx * qy + qw * qz);
      case 4: return one - two * (qx * qx + qz * qz);
      case 5: return two * (qy * qz - qw * qx);
      case 6: return two * (qx * qz - qw * qy);
      case 7: return two * (qy * qz + qw * qx);
      default: return one - two * (qx * qx + qy * qy);
    }
  }

  // rows 0, 11, 12, 13
  template <typename T>
  __host__ __device__ static T row_u(int r, const T* u, const T* par) {
    const T alpha_m = par[0];
    const T* J_B = par + 4;
    const T* r_T_B = par + 7;
    const T t0 = u[0], t1 = u[1], t2 = u[2];
    const T zero(0);
    switch (r) {
      case 0: return (-alpha_m) * dsqrt(t0 * t0 + t1 * t1 + t2 * t2);
      case 11: return tdiv(r_T_B[1] * t2 - r_T_B[2] * t1 + zero, J_B[0]);
      case 12: return tdiv(r_T_B[2] * t0 - r_T_B[0] * t2 + zero, J_B[1]);
      default: return tdiv(r_T_B[0] * t1 - r_T_B[1] * t0 + u[3], J_B[2]);
    }
  }

  // rows 1 .. 10: the velocity, (R t) / mass + g_I, the quaternion rate
  template <typename T, typename X>
  __host__ __device__ static T row_x(int r, const X& x, const T* u,
                                     const T* par) {
    const T half(0.5);
    const T qw = x[7], qx = x[8], qy = x[9], qz = x[10];
    if (r <= 3) return x[r + 3];
    if (r <= 6) {
      const int a = r - 4;
      return tdiv(rot(a, 0, qw, qx, qy, qz) * u[0] +
                      rot(a, 1, qw, qx, qy, qz) * u[1] +
                      rot(a, 2, qw, qx, qy, qz) * u[2],
                  T(x[0])) +
             par[1 + a];
    }
    const T w0 = x[11], w1 = x[12], w2 = x[13];
    switch (r) {
      case 7: return half * ((-w0) * qx - w1 * qy - w2 * qz);
      case 8: return half * (w0 * qw + w2 * qy - w1 * qz);
      case 9: return half * (w1 * qw - w2 * qx + w0 * qz);
      default: return half * (w2 * qw + w1 * qx - w0 * qy);
    }
  }

  // the whole flow map on one thread, the reference's expressions as
  // the one-thread kernels have always compiled them: the discretize
  // kernel evaluates it on values and on dual numbers. row_u and row_x
  // hold the same expressions row by row: edit them with it
  // (tests/test_torch_disc_mono.py holds the three bit for bit)
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

// The slope sums, in the order of integrators.rk_step: the stage input
// y + sum_{j<i} (h a_ij) k_j over every j (zero coefficients included, as
// there), the step y + sum_i (h b_i) k_i over the nonzero weights only,
// each coefficient T(h a_ij), T(h b_i) rounded once. Both kernels form
// them so.

// ---------------------------------------------------------------------------
// Discretize: one interval per block of `nthreads` threads (a multiple of
// 32; the kernel launches kDiscThreads = 64, two warps).
//
// The augmented state is [x | Y], Y = [Phi | Y_B | (Y_C) | y_z] (n rows,
// ncols columns), integrated under
//   x' = dt f(x, u(tau)),
//   Y' = dt (A Y + [0 | B (1 - tau) | B tau | f - A x - B u])   (FOH)
//   Y' = dt (A Y + [0 | B | f - A x - B u])                      (ZOH)
// The state's recursion does not read Y; the stage Jacobians [A | B]_i,
// f_i and r_i = f_i - A_i x_i - B_i u_i depend only on stage i's x input
// and u(tau_i); and each column of Y evolves on its own given them. So
// each substep runs three parts, a block barrier after each:
//  (a) the x chain: the last warp integrates x through the substep's
//      stages, lane r < n owning row r of x (its stage slopes dt f_i read
//      back from shared memory), lane 0 evaluating the flow map on each
//      stage input; x_i, u(tau_i) and f_i go to shared memory;
//  (b) the Jacobians: the substep's stages times its n + m input
//      directions, kDiscDirs directions of a stage to a thread, each an
//      evaluation of the flow map on dual numbers with kDiscDirs tangents
//      (its columns of [A | B]_i, stored as rows of the transpose); after
//      a barrier the threads form r_i, one row each;
//  (c) the Y recursion: thread c < ncols owns column c of Y (its n values
//      in registers, its stage slopes in shared memory) and takes it
//      through the substep's stages with no barrier: per stage one n x n
//      matrix-vector product A_i y (rows of the transpose read four at a
//      time), R's column and the slope dt (A_i y + R_i).
// The last warp runs the next substep's x chain while the first runs this
// one's Y recursion: (a) writes nothing (c) reads. Every sum runs in the
// order of the layout this replaced (and of `_disc_plain` up to
// reassociation): stage inputs and steps in the slope sums' order,
// A y over q ascending from zero, then R, then dt; r as f - (A x) - (B u).
// So no output depends on the thread count. Against the one-warp layout
// this replaced, the outputs move by an ulp or so in float32 on the card
// once tdiv below takes the tangents' zero numerators off the device's
// division (diag/disc_versus.py compares the two builds).
//
// The code is kept small: an SM fetches the instructions of all its warps
// through one instruction cache, and four warps each in its own 8 KB of
// code already halve the issue rate (diag/pipe_probe.py, "icode"). So the
// stage loops are not unrolled: the tableau's step coefficients (h a_ij,
// h b_i, each rounded to T once) and
// nodes sit in shared memory, and one copy of each part's code serves
// every stage.

constexpr int kDiscThreads = 64;
constexpr int kDiscDirs = 2;  // Jacobian columns a thread evaluates at once

__host__ __device__ constexpr int up4(int v) { return (v + 3) / 4 * 4; }

template <class Model, class Tab, bool FOH, typename T>
struct DiscShape {
  static constexpr int n = Model::n, m = Model::m, nm = n + m;
  static constexpr int ncols = n + m + (FOH ? m : 0) + 1;
  static constexpr int np = up4(n);  // a column, padded to 4
  // a row of [A | B] transposed: np, plus 16 bytes, so that the rows of
  // consecutive threads start in different banks
  static constexpr int js = np + 16 / int(sizeof(T));
  static constexpr int S = Tab::S;
  // stages evaluated (a prefix: only dopri5's last, FSAL, stage is not)
  static constexpr int SU = used<Tab>(S - 1) ? S : S - 1;
  static_assert(n <= 32 && m <= 32 && ncols <= 32,
                "the x chain and the columns of Y take one warp each");
  // shared memory, in elements of T, every region at a multiple of 4 (16
  // bytes in float): x_i (SU, n), u(tau_i) (SU, m), f_i (SU, n), r_i
  // (SU, np), [A | B]_i transposed (SU, nm, js), the columns' stage slopes
  // (SU, np / 4, ncols) quads (a column's quads ncols apart, so that the
  // columns read consecutive quads), a zero column (np), the coefficients
  // T(h a_ij) (SU, S - 1) and T(h b_i) (S), the parameters (p); then the
  // nodes c_i as doubles (SU)
  static constexpr int xs = 0;
  static constexpr int us = up4(xs + SU * n);
  static constexpr int fs = up4(us + SU * m);
  static constexpr int rs = up4(fs + SU * n);
  static constexpr int JT = up4(rs + SU * np);
  static constexpr int ks = up4(JT + SU * nm * js);
  static constexpr int zc = up4(ks + SU * ncols * np);
  static constexpr int ca = zc + np;
  static constexpr int cb = ca + SU * (S - 1);
  static constexpr int ps = cb + S;
  static constexpr int elems = up4(ps + Model::p);
};

// shared memory of the discretize body, bytes: the T elements, then the
// nodes
template <class Model, class Tab, bool FOH, typename T>
__host__ __device__ constexpr long long disc_smem_bytes() {
  using Sh = DiscShape<Model, Tab, FOH, T>;
  return (long long)Sh::elems * sizeof(T) + 8LL * Sh::SU;
}

// Per-part clock counters (optional): thread 0 (column 0 of Y) reads
// clock64() after the barrier that ends each part and adds the cycles
// since its last reading to that part: the x chain (the first substep's,
// then each substep's wait for the next one's after its own Y recursion),
// the Jacobians with r, the Y recursion. The two slots after the parts
// hold the block's whole run in clock64() cycles and in globaltimer
// nanoseconds.
enum DiscPhase { kXChain, kJacobians, kYRecursion, kDiscPhases };
constexpr int kDiscProfSlots = kDiscPhases + 2;

#ifdef __CUDACC__
__device__ __forceinline__ long long wall_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}
#endif

template <typename T>
struct alignas(16) Quad {
  T v[4];
};

// a product rounded on its own, never fused into a following sum
__host__ __device__ inline float mul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
__host__ __device__ inline double mul_rn(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}

// v[0 .. R) from quads p[0], p[stride], ... (R rounded up to 4 readable);
// store_quads writes them back, zeros in the padding
template <int R, typename T>
__host__ __device__ inline void load_quads(const Quad<T>* p, int stride,
                                           T (&v)[R]) {
#pragma unroll
  for (int r = 0; r < R; r += 4) {
    const Quad<T> q = p[(r / 4) * stride];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (r + e < R) v[r + e] = q.v[e];
  }
}
template <int R, typename T>
__host__ __device__ inline void store_quads(Quad<T>* p, int stride,
                                            const T (&v)[R]) {
#pragma unroll
  for (int r = 0; r < R; r += 4) {
    Quad<T> q;
#pragma unroll
    for (int e = 0; e < 4; ++e) q.v[e] = r + e < R ? v[r + e] : T(0);
    p[(r / 4) * stride] = q;
  }
}
// the same for contiguous values at p (16-byte aligned)
template <int R, typename T>
__host__ __device__ inline void load_col(const T* p, T (&v)[R]) {
  load_quads(reinterpret_cast<const Quad<T>*>(p), 1, v);
}
template <int R, typename T>
__host__ __device__ inline void store_col(T* p, const T (&v)[R]) {
  store_quads(reinterpret_cast<Quad<T>*>(p), 1, v);
}

// The slope sums for a stage index known only at run time, in their
// order, with the coefficients read from
// ca_i[j] = T(h a_ij) and cb[i] = T(h b_i); slope(j, k) puts stage j's
// slope in k. The loops run to their compile-time bounds with the stage's
// own terms predicated, so the slope loads can be issued ahead.
template <class Tab, int R, typename T, class F>
__host__ __device__ inline void stage_input_at(const T (&y)[R], int i,
                                               const T* ca_i, F&& slope,
                                               T (&yi)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) yi[r] = y[r];
#pragma unroll
  for (int j = 0; j < Tab::S - 1; ++j) {
    if (j < i) {
      const T coef = ca_i[j];
      T kj[R];
      slope(j, kj);
#pragma unroll
      for (int r = 0; r < R; ++r) yi[r] = yi[r] + coef * kj[r];
    }
  }
}

template <class Tab, int R, typename T, class F>
__host__ __device__ inline void step_update_at(T (&y)[R], const T* cb,
                                               F&& slope) {
#pragma unroll
  for (int i = 0; i < Tab::S; ++i) {
    if (Tab::b(i) != 0.0) {
      const T coef = cb[i];
      T ki[R];
      slope(i, ki);
#pragma unroll
      for (int r = 0; r < R; ++r) y[r] = y[r] + coef * ki[r];
    }
  }
}

// Interval `iv` of B * (K - 1): X (B, K, n), U (B, KU, m) with KU = K
// (FOH) or K - 1 (ZOH), t (B,), par (B, p); A (B, K-1, n, n),
// Bm and C (B, K-1, n, m), z (B, K-1, n). `smem` holds disc_smem_bytes
// (16-byte aligned); `prof` is null or this block's kDiscProfSlots
// counters. Needs nthreads % 32 == 0 and nthreads >= 32.
template <class Model, class Tab, bool FOH, typename T>
__device__ void disc_block(long long iv, int tid, int nthreads, int K,
                           int KU, int substeps, const T* X, const T* U,
                           const T* ts, const T* par, T* A, T* Bm, T* C,
                           T* z, T* smem, long long* prof) {
  using Sh = DiscShape<Model, Tab, FOH, T>;
  constexpr int n = Sh::n, m = Sh::m, nm = Sh::nm, ncols = Sh::ncols;
  constexpr int np = Sh::np, js = Sh::js, SU = Sh::SU, S = Sh::S;
  const long long b = iv / (K - 1);
  const int k = (int)(iv % (K - 1));
  const T* xk = X + (b * K + k) * n;
  const T* u0g = U + (b * KU + k) * m;
  const T* u1g = FOH ? u0g + m : u0g;
  const T dt = ts[b] / T(K - 1);
  const double h = 1.0 / substeps;

  T* xs = smem + Sh::xs;
  T* us = smem + Sh::us;
  T* fs = smem + Sh::fs;
  T* rs = smem + Sh::rs;
  T* JT = smem + Sh::JT;
  T* ks = smem + Sh::ks;
  T* zc = smem + Sh::zc;
  T* ca = smem + Sh::ca;
  T* cb = smem + Sh::cb;
  T* pb = smem + Sh::ps;
  double* cn = reinterpret_cast<double*>(smem + Sh::elems);

  // the parameters and the tableau go to shared memory once
  for (int j = tid; j < Model::p; j += nthreads) pb[j] = par[b * Model::p + j];
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < SU; ++i) {
      cn[i] = Tab::c(i);
#pragma unroll
      for (int j = 0; j < S - 1; ++j) ca[i * (S - 1) + j] = T(h * Tab::a(i, j));
    }
#pragma unroll
    for (int i = 0; i < S; ++i) cb[i] = T(h * Tab::b(i));
#pragma unroll
    for (int r = 0; r < np; ++r) zc[r] = T(0);
  }

  long long pacc[kDiscPhases] = {}, t_last = 0, t0_cycles = 0, t0_ns = 0;
  const bool counting = prof != nullptr && tid == 0;
  if (counting) {
    t_last = t0_cycles = clock64();
    t0_ns = wall_ns();
  }
  auto tick = [&](int phase) {
    if (!counting) return;
    const long long now = clock64();
    pacc[phase] += now - t_last;
    t_last = now;
  };

  // the x chain (the last warp): lane r < n holds row r of x, lane j < m
  // u's entry j
  const int lane = tid - (nthreads - 32);
  const bool xwarp = lane >= 0;
  T xv[1] = {T(0)}, u0 = T(0), du = T(0);
  if (xwarp && lane < n) xv[0] = xk[lane];
  if (xwarp && lane < m) {
    u0 = u0g[lane];
    du = u1g[lane] - u0g[lane];
  }
  auto x_slope = [&](int j, T (&kj)[1]) { kj[0] = dt * fs[j * n + lane]; };
  // substep s's stages: x_i, u_i, f_i
  auto x_chain = [&](int s) {
#pragma unroll 1
    for (int i = 0; i < SU; ++i) {
      const double tau = s * h + cn[i] * h;
      if (lane < n) {
        T xi[1];
        stage_input_at<Tab>(xv, i, ca + i * (S - 1), x_slope, xi);
        xs[i * n + lane] = xi[0];
      }
      if (lane < m) us[i * m + lane] = FOH ? u0 + T(tau) * du : u0;
      __syncwarp();
      if (lane == 0) {
        T xl[n], ul[m], fl[n];
#pragma unroll
        for (int r = 0; r < n; ++r) xl[r] = xs[i * n + r];
#pragma unroll
        for (int j = 0; j < m; ++j) ul[j] = us[i * m + j];
        Model::flow(xl, ul, pb, fl);
#pragma unroll
        for (int r = 0; r < n; ++r) fs[i * n + r] = fl[r];
      }
      __syncwarp();
    }
    if (lane < n) step_update_at<Tab>(xv, cb, x_slope);
  };

  // column c of Y (thread c < ncols): Phi starts at the identity
  const int c = tid;
  const bool ycol = c < ncols;
  T y[n];
#pragma unroll
  for (int r = 0; r < n; ++r) y[r] = T(r == c ? 1 : 0);
  // this column's slope of stage i: quads kc[(i np / 4 + q) ncols]
  Quad<T>* kc = reinterpret_cast<Quad<T>*>(ks) + c;
  auto y_slope = [&](int j, T (&kj)[n]) {
    load_quads(kc + j * (np / 4) * ncols, ncols, kj);
  };

  // s = -1 only runs the first substep's x chain
  __syncthreads();
  for (int s = -1; s < substeps; ++s) {
    if (s >= 0) {
      // (b) [A | B]_i's columns j0 .. j0 + KD - 1: one evaluation on dual
      // numbers with KD tangents each
      constexpr int KD = kDiscDirs, groups = (nm + KD - 1) / KD;
      for (int w = tid; w < SU * groups; w += nthreads) {
        const int i = w / groups, j0 = (w % groups) * KD;
        Dual<T, KD> xd[n], ud[m], fd[n];
#pragma unroll
        for (int r = 0; r < n; ++r) {
          xd[r].v = xs[i * n + r];
#pragma unroll
          for (int e = 0; e < KD; ++e) xd[r].d[e] = T(r == j0 + e);
        }
#pragma unroll
        for (int q = 0; q < m; ++q) {
          ud[q].v = us[i * m + q];
#pragma unroll
          for (int e = 0; e < KD; ++e) ud[q].d[e] = T(n + q == j0 + e);
        }
        Model::flow(xd, ud, pb, fd);
#pragma unroll
        for (int e = 0; e < KD; ++e) {
          if (j0 + e < nm) {
            T col[n];
#pragma unroll
            for (int r = 0; r < n; ++r) col[r] = fd[r].d[e];
            store_col(JT + (i * nm + j0 + e) * js, col);
          }
        }
      }
      __syncthreads();
      // r_i = f_i - A_i x_i - B_i u_i, one row each
      for (int w = tid; w < SU * n; w += nthreads) {
        const int i = w / n, r = w % n;
        const T* JTi = JT + i * nm * js;
        T ax = T(0), bu = T(0);
#pragma unroll
        for (int q = 0; q < n; ++q) ax = ax + JTi[q * js + r] * xs[i * n + q];
#pragma unroll
        for (int j = 0; j < m; ++j)
          bu = bu + JTi[(n + j) * js + r] * us[i * m + j];
        rs[i * np + r] = fs[i * n + r] - ax - bu;
      }
      __syncthreads();
      tick(kJacobians);

      // (c) the Y recursion of column c
      if (ycol) {
#pragma unroll 1
        for (int i = 0; i < SU; ++i) {
          const double tau = s * h + cn[i] * h;
          T yi[n];
          stage_input_at<Tab>(y, i, ca + i * (S - 1), y_slope, yi);
          const T* JTi = JT + i * nm * js;
          T acc[n];
#pragma unroll
          for (int r = 0; r < n; ++r) acc[r] = T(0);
#pragma unroll
          for (int q = 0; q < n; ++q) {
            T a[n];
            load_col(JTi + q * js, a);
#pragma unroll
            for (int r = 0; r < n; ++r) acc[r] = acc[r] + a[r] * yi[q];
          }
          // R's column c: zero under Phi (0 x 1), then B (1 - tau) | B tau
          // (FOH) or B (ZOH), then r (r x 1)
          const bool bcol = c >= n && c < ncols - 1, first = c < n + m;
          const T* src = c == ncols - 1 ? rs + i * np
                         : bcol          ? JTi + (first ? c : c - m) * js
                                         : zc;
          const T wr = !bcol ? T(1) : first ? (FOH ? T(1.0 - tau) : T(1))
                                            : T(tau);
          T Rc[n];
          load_col(src, Rc);
          T kq[n];
#pragma unroll
          for (int r = 0; r < n; ++r)
            kq[r] = dt * (acc[r] + mul_rn(Rc[r], wr));
          store_quads(kc + i * (np / 4) * ncols, ncols, kq);
        }
        step_update_at<Tab>(y, cb, y_slope);
      }
      tick(kYRecursion);
    }
    // (a) the next substep's x chain, beside this one's Y recursion
    if (xwarp && s + 1 < substeps) x_chain(s + 1);
    __syncthreads();
    tick(kXChain);
  }

  if (ycol) {
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
  if (counting) {
    for (int p = 0; p < kDiscPhases; ++p) prof[p] = pacc[p];
    prof[kDiscPhases] = clock64() - t0_cycles;
    prof[kDiscPhases + 1] = wall_ns() - t0_ns;
  }
}

// ---------------------------------------------------------------------------
// Resim: J[b] = sum_k sum_i |x_end(k)_i - X[b, k+1, i]|, one scenario per
// block, an interval a lane, the rows of x over the block's warps.
//
// Warp ResimWarps<Model>::warp(r) owns row r of every interval of a round
// (32 intervals, one a lane): it forms its rows of each stage input and
// step update (its slopes in registers, the stages unrolled, the sums in
// the slope sums' order), writes its stage-input rows to shared memory,
// and after the block's barrier evaluates its rows of the flow map
// (row_x, reading the stage input's other rows there) and their slopes
// dt f_r, rounded once. A row that does not read x (row_u: the mass rate
// and the angular accelerations of RocketQuat) and u(tau) itself are
// computed before the barrier, beside the chain: they wait for no other
// warp. So a stage's chain is one barrier and, on each warp, its rows of
// the flow map, where one thread an interval ran every row in turn. The
// device's division and square root are the long parts of a row (each
// runs one after another within a warp), so the warp map spreads them
// over the warps. Every row keeps its expression and every sum its
// order, so J does not depend on the lane or the round an interval
// lands in.
//
// The defect: each warp forms |x_end,r - X[b, k+1, r]| of its rows (x_{k+1}
// loaded ahead), warp 0 adds the n rows of its lane's interval in state
// order; then thread 0 adds the intervals in interval order, a round at a
// time, as the one-thread-an-interval layout this replaced did. No
// atomics: the result does not depend on the launch.

// The resim block's warps and the warp of each row, by model
template <class Model>
struct ResimWarps;

// RocketQuat: the mass rate (a square root) with the copies; each
// acceleration row alone (a division by the mass each); the quaternion
// rates with the last angular acceleration; the first two angular
// accelerations. Each warp runs the divisions and square roots of its
// rows one after another, and seven or eight warps ran slower than six on
// the card (PERF.md, section 6, PR 13).
template <>
struct ResimWarps<RocketQuat> {
  static constexpr int warps = 6;
  __host__ __device__ static constexpr int warp(int r) {
    return r <= 3 ? 0 : r <= 6 ? r - 3 : r <= 10 || r == 13 ? 4 : 5;
  }
};

// shared memory of a block, bytes: the stage inputs (two buffers of
// (n, 32), stages alternate), the defect's terms (n, 32), the intervals'
// sums of a round (32), the parameters
template <class Model, typename T>
__host__ __device__ constexpr long long resim_smem_bytes() {
  return (long long)sizeof(T) * (3 * Model::n * 32 + 32 + up4(Model::p));
}

// row i of an (n, 32) buffer at one lane
template <typename T>
struct LaneCol {
  const T* p;
  __host__ __device__ T operator[](int i) const { return p[i * 32]; }
};

// f(integral_constant<W>) for warp w, so that each warp's code holds its
// own rows alone
template <int Warps, int W = 0, class F>
__device__ __forceinline__ void on_warp(int w, F&& f) {
  if constexpr (W < Warps) {
    if (w == W)
      f(std::integral_constant<int, W>{});
    else
      on_warp<Warps, W + 1>(w, f);
  }
}

// The rows of warp W (ResimWarps<Model>::warp(r) == W) of one interval at
// one lane through every substep: x_k from xk, the inputs u0g, u1g, the
// parameters pb; the stage inputs go through xs (two (n, 32) buffers);
// the rows' x_end returned in y (the other entries unused).
template <class Model, class Tab, bool FOH, int W, typename T>
__device__ __forceinline__ void resim_rows(int lane, int substeps, T dt,
                                           const T* xk, const T* u0g,
                                           const T* u1g, const T* pb, T* xs,
                                           T (&y)[Model::n]) {
  using Rows = ResimWarps<Model>;
  constexpr int n = Model::n, m = Model::m, S = Tab::S;
  constexpr int SU = used<Tab>(S - 1) ? S : S - 1;
  const double h = 1.0 / substeps;
  // T(h a_ij) and T(h b_i), each rounded once
  T ca[SU][S - 1], cb[S];
#pragma unroll
  for (int i = 0; i < SU; ++i)
#pragma unroll
    for (int j = 0; j < S - 1; ++j) ca[i][j] = T(h * Tab::a(i, j));
#pragma unroll
  for (int i = 0; i < S; ++i) cb[i] = T(h * Tab::b(i));
#pragma unroll
  for (int r = 0; r < n; ++r)
    if (Rows::warp(r) == W) y[r] = xk[r];
  T u0[m], du[m];
#pragma unroll
  for (int j = 0; j < m; ++j) {
    u0[j] = u0g[j];
    du[j] = u1g[j] - u0g[j];
  }
  for (int s = 0; s < substeps; ++s) {
    const double t0 = s * h;
    T kk[SU][n];
#pragma unroll
    for (int i = 0; i < SU; ++i) {
      const double tau = t0 + Tab::c(i) * h;
      T u[m];
#pragma unroll
      for (int j = 0; j < m; ++j) u[j] = FOH ? u0[j] + T(tau) * du[j] : u0[j];
      T* xb = xs + ((s * SU + i) & 1) * n * 32;
      T f[n];
#pragma unroll
      for (int r = 0; r < n; ++r) {
        if (Rows::warp(r) != W) continue;
        T yi = y[r];
#pragma unroll
        for (int j = 0; j < S - 1; ++j)
          if (j < i) yi = yi + ca[i][j] * kk[j][r];
        xb[r * 32 + lane] = yi;
        if (!Model::reads_x(r)) f[r] = Model::row_u(r, u, pb);
      }
      // Each warp reaches this barrier in its own instantiation, so the
      // warps execute different bar.sync instructions. PTX defines
      // bar.sync as barrier.sync.aligned, which asks every thread of the
      // block to execute the same one; this relies on sm_90 counting the
      // arrivals at barrier 0 whatever instruction they come from, as it
      // does (J bit for bit on the card). The non-aligned barrier.sync
      // grew the float32 kernel from 49 to 57 KB of code and ran slower
      // (PERF.md, section 6, PR 13).
      __syncthreads();
      const LaneCol<T> x{xb + lane};
#pragma unroll
      for (int r = 0; r < n; ++r) {
        if (Rows::warp(r) != W) continue;
        if (Model::reads_x(r)) f[r] = Model::template row_x<T>(r, x, u, pb);
        kk[i][r] = dt * f[r];
      }
    }
#pragma unroll
    for (int i = 0; i < S; ++i)
      if (Tab::b(i) != 0.0)
#pragma unroll
        for (int r = 0; r < n; ++r)
          if (Rows::warp(r) == W) y[r] = y[r] + cb[i] * kk[i < SU ? i : 0][r];
  }
}

// Scenario `b`: ResimWarps<Model>::warps warps of 32 threads, an interval
// a lane; `smem` holds resim_smem_bytes.
template <class Model, class Tab, bool FOH, typename T>
__device__ void resim_block(long long b, int tid, int K, int KU,
                            int substeps, const T* X, const T* U,
                            const T* ts, const T* par, T* Jout, T* smem) {
  using Rows = ResimWarps<Model>;
  constexpr int n = Model::n, m = Model::m, S = Tab::S;
  static_assert(used<Tab>(S - 1) || Tab::b(S - 1) == 0.0,
                "every weighted stage is evaluated");
  const int w = tid / 32, lane = tid % 32;
  T* xs = smem;
  T* ds = xs + 2 * n * 32;
  T* red = ds + n * 32;
  T* pb = red + 32;

  for (int j = tid; j < Model::p; j += 32 * Rows::warps)
    pb[j] = par[b * Model::p + j];
  const T dt = ts[b] / T(K - 1);
  __syncthreads();

  T J = T(0);
  for (int k0 = 0; k0 < K - 1; k0 += 32) {
    // a lane past the round's intervals runs the last one and keeps
    // nothing
    const bool live = k0 + lane < K - 1;
    const int k = live ? k0 + lane : K - 2;
    const T* xk = X + (b * K + k) * n;
    const T* u0g = U + (b * KU + k) * m;
    on_warp<Rows::warps>(w, [&](auto wc) {
      constexpr int W = decltype(wc)::value;
      // x_{k+1}'s rows, loaded ahead
      T xn[n], y[n];
#pragma unroll
      for (int r = 0; r < n; ++r)
        if (Rows::warp(r) == W) xn[r] = xk[n + r];
      resim_rows<Model, Tab, FOH, W>(lane, substeps, dt, xk, u0g,
                                     FOH ? u0g + m : u0g, pb, xs, y);
      // the defect's terms of these rows
#pragma unroll
      for (int r = 0; r < n; ++r)
        if (Rows::warp(r) == W) ds[r * 32 + lane] = dabs(y[r] - xn[r]);
    });
    __syncthreads();
    // the n rows of each interval in state order, on warp 0
    if (w == 0 && live) {
      T d = T(0);
#pragma unroll
      for (int r = 0; r < n; ++r) d = d + ds[r * 32 + lane];
      red[lane] = d;
    }
    __syncthreads();
    if (tid == 0) {
      // the round's sums, loaded at once, added in interval order
      const int cnt = 32 < K - 1 - k0 ? 32 : K - 1 - k0;
      T v[32];
#pragma unroll
      for (int l = 0; l < 32; ++l) v[l] = l < cnt ? red[l] : T(0);
#pragma unroll
      for (int l = 0; l < 32; ++l)
        if (l < cnt) J = J + v[l];
    }
  }
  if (tid == 0) Jout[b] = J;
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
