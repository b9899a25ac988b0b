"""The fused discretize and resim kernels against their plain versions
(``ops/disc_mono._disc_plain`` and ``_resim_plain``), and the fused SCvx
path against the unfused one.

``scpp_tpu_torch/csrc/disc_mono_body.cuh`` holds everything the two
kernels compute; ``disc_mono.cu`` only launches it. On the CPU the header
is compiled with g++ under ``csrc/host_shim.h`` (each CUDA thread a
``std::thread``, ``__syncthreads`` a barrier) and run block by block, so
the kernels' arithmetic, their per-thread roles and their barriers are
checked here in float64 and float32; the ``cuda`` test launches the real
kernels and skips without a GPU. The plain versions are held against the
JAX package in test_torch_dynamics.py. This module imports no JAX:
``python -m pytest tests/test_torch_disc_mono.py --noconftest -q``.
"""

import ctypes
import dataclasses
import functools
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

from scpp_tpu_torch.algos.scvx import solve_scvx
from scpp_tpu_torch.configs.algorithms import SCvxConfig
from scpp_tpu_torch.models import RocketQuat
from scpp_tpu_torch.models.base import batch_params
from scpp_tpu_torch.ops import disc_mono
from scpp_tpu_torch.solver.ipm import IPMSettings
from scpp_tpu_torch.trajectory import TrajectoryData

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scpp_tpu_torch", "csrc")
F64 = torch.float64
K, SUBSTEPS = 5, 3
VARIANTS = [(True, "dopri5"), (True, "rk4"), (False, "dopri5"),
            (False, "rk4")]
VARIANT_IDS = ["foh-dopri5", "foh-rk4", "zoh-dopri5", "zoh-rk4"]

# Built once per element type, in parallel (HOST_F32 or not), and linked
# into one library. The discretize body runs at the kernel's own block
# (kDiscThreads threads) unless told otherwise.
HARNESS = r"""
#include "disc_mono_body.cuh"
#include <limits>
#include <thread>
#include <vector>

// blocks 0 .. nblocks - 1 one after another on one set of threads:
// body(block, tid), then a barrier, then `between` on thread 0 and a
// barrier before the next block
template <class F, class G>
void run_blocks(int nthreads, long long nblocks, F&& body, G&& between) {
  std::barrier<> bar(nthreads);
  g_barrier = &bar;
  HostWarps warps(nthreads);
  blockDim.x = nthreads;
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t)
    threads.emplace_back([&, t]() {
      threadIdx.x = t;
      for (long long blk = 0; blk < nblocks; ++blk) {
        if (t == 0) between();
        bar.arrive_and_wait();
        body(blk, t);
        bar.arrive_and_wait();
      }
    });
  for (auto& th : threads) th.join();
}

// every block starts from shared memory full of NaN, so a read of a value
// the block did not write shows in its outputs
template <typename T>
int disc_run(int method, int foh, int nthreads, int B, int K, int KU,
             int substeps, const T* X, const T* U, const T* t, const T* par,
             T* A, T* Bm, T* C, T* z, long long* prof) {
  return disc::dispatch(sizeof(T), 0, method, foh, -1,
      [&](auto mdl, auto tab, auto fh, auto) {
        using Model = decltype(mdl);
        using Tab = decltype(tab);
        constexpr bool FOH = decltype(fh)::value;
        if (nthreads < 32 || nthreads % 32 != 0) return -1;
        std::vector<T> smem(disc::disc_smem_bytes<Model, Tab, FOH, T>() /
                            sizeof(T));
        run_blocks(nthreads, (long long)B * (K - 1),
            [&](long long iv, int tid) {
              disc::disc_block<Model, Tab, FOH, T>(
                  iv, tid, nthreads, K, KU, substeps, X, U, t, par, A, Bm,
                  C, z, smem.data(),
                  prof ? prof + iv * disc::kDiscProfSlots : nullptr);
            },
            [&]() {
              std::fill(smem.begin(), smem.end(),
                        std::numeric_limits<T>::quiet_NaN());
            });
        return 0;
      });
}

template <typename T>
int resim_run(int method, int foh, int B, int K, int KU, int substeps,
              const T* X, const T* U, const T* t, const T* par, T* J) {
  return disc::dispatch(sizeof(T), 0, method, foh, -1,
      [&](auto mdl, auto tab, auto fh, auto) {
        using Model = decltype(mdl);
        using Tab = decltype(tab);
        constexpr bool FOH = decltype(fh)::value;
        std::vector<T> smem(disc::resim_smem_bytes<Model, T>() / sizeof(T));
        run_blocks(32 * disc::ResimWarps<Model>::warps, B,
            [&](long long b, int tid) {
              disc::resim_block<Model, Tab, FOH, T>(b, tid, K, KU, substeps,
                                                    X, U, t, par, J,
                                                    smem.data());
            },
            [&]() {
              std::fill(smem.begin(), smem.end(),
                        std::numeric_limits<T>::quiet_NaN());
            });
        return 0;
      });
}

// the model's flow map on N points three ways: flow; each row alone by
// row_u or row_x, as a resim thread that owns it evaluates it, x read
// through a strided column as there; and the value of flow on dual
// numbers
template <typename T>
int flow_parts(int N, const T* x, const T* u, const T* par, T* f_flow,
               T* f_parts, T* f_dual) {
  using M = disc::RocketQuat;
  constexpr int n = M::n, m = M::m;
  using D = disc::Dual<T, disc::kDiscDirs>;
  for (int i = 0; i < N; ++i) {
    const T* xi = x + i * n;
    const T* ui = u + i * m;
    const T* pi = par + i * M::p;
    M::flow(xi, ui, pi, f_flow + i * n);
    T col[n * 32], ul[m];
    for (int r = 0; r < n; ++r) col[r * 32] = xi[r];
    std::copy(ui, ui + m, ul);
    const disc::LaneCol<T> xc{col};
    for (int r = 0; r < n; ++r)
      f_parts[i * n + r] = M::reads_x(r) ? M::row_x<T>(r, xc, ul, pi)
                                         : M::row_u(r, ul, pi);
    D xd[n], ud[m], fd[n];
    for (int r = 0; r < n; ++r) xd[r] = D{xi[r], {}};
    for (int r = 0; r < m; ++r) ud[r] = D{ui[r], {}};
    M::flow(xd, ud, pi, fd);
    for (int r = 0; r < n; ++r) f_dual[i * n + r] = fd[r].v;
  }
  return 0;
}

#define HOST_RUN(sfx, T)                                                  \
  extern "C" int host_disc##sfx(int method, int foh, int nthreads, int B,  \
                                int K, int KU, int substeps, const T* X,  \
                                const T* U, const T* t, const T* par,     \
                                T* A, T* Bm, T* C, T* z,                  \
                                long long* prof) {                        \
    return disc_run<T>(method, foh, nthreads, B, K, KU, substeps, X, U,   \
                       t, par, A, Bm, C, z, prof);                        \
  }                                                                       \
  extern "C" int host_resim##sfx(int method, int foh, int B, int K,      \
                                 int KU, int substeps, const T* X,        \
                                 const T* U, const T* t, const T* par,    \
                                 T* J) {                                  \
    return resim_run<T>(method, foh, B, K, KU, substeps, X, U, t, par,    \
                        J);                                               \
  }                                                                       \
  extern "C" int host_flow_parts##sfx(int N, const T* x, const T* u,      \
                                      const T* par, T* f_flow,            \
                                      T* f_parts, T* f_dual) {            \
    return flow_parts<T>(N, x, u, par, f_flow, f_parts, f_dual);          \
  }
#ifdef HOST_F32
HOST_RUN(_f32, float)
#else
thread_local Dim3 threadIdx;
Dim3 blockDim;
std::barrier<>* g_barrier;
SpinBarrier** g_warp_barriers;
unsigned long long (*g_warp_xch)[2][32];
HOST_RUN(, double)

extern "C" int host_disc_threads() { return disc::kDiscThreads; }
extern "C" long long host_resim_smem_bytes(int elem_bytes) {
  return elem_bytes == 4
             ? disc::resim_smem_bytes<disc::RocketQuat, float>()
             : disc::resim_smem_bytes<disc::RocketQuat, double>();
}
extern "C" int host_disc_prof_slots() { return disc::kDiscProfSlots; }
extern "C" long long host_disc_smem_bytes(int elem_bytes, int method,
                                          int foh) {
  return disc::dispatch(elem_bytes, 0, method, foh, 0,
      [&](auto mdl, auto tab, auto fh, auto val) {
        return (int)disc::disc_smem_bytes<decltype(mdl), decltype(tab),
                                          decltype(fh)::value,
                                          decltype(val)>();
      });
}

// f (N, n) and [A | B] (N, n, n + m) of the model on dual numbers,
// kDiscDirs directions at a time, as the discretize kernel's threads
// evaluate them
extern "C" int host_flow_jac(int N, const double* x, const double* u,
                             const double* par, double* f, double* J) {
  using M = disc::RocketQuat;
  constexpr int n = M::n, m = M::m, K = disc::kDiscDirs;
  using D = disc::Dual<double, K>;
  for (int i = 0; i < N; ++i) {
    for (int j0 = 0; j0 < n + m; j0 += K) {
      D xd[n], ud[m], fd[n];
      for (int r = 0; r < n; ++r) {
        xd[r].v = x[i * n + r];
        for (int e = 0; e < K; ++e) xd[r].d[e] = r == j0 + e;
      }
      for (int r = 0; r < m; ++r) {
        ud[r].v = u[i * m + r];
        for (int e = 0; e < K; ++e) ud[r].d[e] = n + r == j0 + e;
      }
      M::flow(xd, ud, par + i * M::p, fd);
      for (int r = 0; r < n; ++r) {
        for (int e = 0; e < K && j0 + e < n + m; ++e)
          J[(i * n + r) * (n + m) + j0 + e] = fd[r].d[e];
        if (j0 == 0) f[i * n + r] = fd[r].v;
      }
    }
  }
  return 0;
}
#endif
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a C++20 compiler is needed to build the kernel body"
    d = tmp_path_factory.mktemp("disc_host")
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libdisc_host.so"
    flags = ([], ["-DHOST_F32"])
    objs = [d / f"harness{i}.o" for i in range(len(flags))]
    builds = [subprocess.Popen(
        [cxx, "-std=c++20", "-O1", "-c", "-fPIC", "-pthread", *flag,
         "-include", os.path.join(CSRC, "host_shim.h"), "-I", CSRC,
         "-o", str(o), str(d / "harness.cpp")], stderr=subprocess.PIPE)
        for o, flag in zip(objs, flags)]
    for b in builds:
        _, err = b.communicate(timeout=120)
        assert b.returncode == 0, err.decode()
    subprocess.run([cxx, "-shared", "-pthread", "-o", str(lib),
                    *map(str, objs)], check=True, capture_output=True,
                   timeout=120)
    so = ctypes.CDLL(str(lib))
    for sfx, c_t in (("", ctypes.c_double), ("_f32", ctypes.c_float)):
        P = ctypes.POINTER(c_t)
        getattr(so, "host_disc" + sfx).argtypes = \
            [ctypes.c_int] * 7 + [P] * 8 + [ctypes.c_void_p]
        getattr(so, "host_resim" + sfx).argtypes = \
            [ctypes.c_int] * 6 + [P] * 5
        getattr(so, "host_flow_parts" + sfx).argtypes = \
            [ctypes.c_int] + [P] * 6
    P = ctypes.POINTER(ctypes.c_double)
    so.host_flow_jac.argtypes = [ctypes.c_int] + [P] * 5
    so.host_disc_smem_bytes.argtypes = [ctypes.c_int] * 3
    so.host_disc_smem_bytes.restype = ctypes.c_longlong
    so.host_resim_smem_bytes.argtypes = [ctypes.c_int]
    so.host_resim_smem_bytes.restype = ctypes.c_longlong
    return so


@functools.lru_cache(maxsize=None)
def inputs(foh, seed=0, k=K):
    """Two RocketQuat scenarios (the second with a 2% heavier start),
    nondimensional, at ``k`` nodes, their initial guesses perturbed by a
    seeded numpy RNG: X, U, t, par in float64."""
    rng = np.random.default_rng(seed)
    p = batch_params(RocketQuat.default_params(F64), 2)
    p = p.replace(x_init=p.x_init * torch.tensor([[1.0], [1.02]], dtype=F64))
    p = RocketQuat.nondimensionalize(p)
    td = RocketQuat.init_trajectory(p, k, foh)
    X = td.X * (1 + 1e-2 * torch.tensor(rng.standard_normal(td.X.shape)))
    U = td.U * (1 + 1e-2 * torch.tensor(rng.standard_normal(td.U.shape)))
    return X, U.contiguous(), td.t, RocketQuat.param_vector(p)


@functools.lru_cache(maxsize=None)
def plain(foh, method):
    """The float64 plain versions: (A, B, C, z) and J."""
    X, U, t, par = inputs(foh)
    args = (RocketQuat, X, U, t, par, SUBSTEPS, method, foh)
    return disc_mono._disc_plain(*args), disc_mono._resim_plain(*args)


def host_run(lib, ins, foh, method, disc_threads=None, prof=None):
    """The host build of both bodies on these inputs: discretize at
    ``disc_threads`` (default: the kernel's own block); ``prof``, an int64
    array of (B (K-1), slots), takes the phase counters."""
    disc_threads = disc_threads or lib.host_disc_threads()
    X, U, t, par = [np.ascontiguousarray(a.numpy()) for a in ins]
    B, K_, n = X.shape
    m = U.shape[-1]
    f32 = X.dtype == np.float32
    sfx = "_f32" if f32 else ""
    P = ctypes.POINTER(ctypes.c_float if f32 else ctypes.c_double)
    outs = [np.full(s, np.nan, X.dtype) for s in
            ((B, K_ - 1, n, n), (B, K_ - 1, n, m), (B, K_ - 1, n, m),
             (B, K_ - 1, n), (B,))]
    ptr = [a.ctypes.data_as(P) for a in (X, U, t, par)]
    mid = disc_mono._METHODS.index(method)
    dims = (B, K_, U.shape[1], SUBSTEPS)
    assert getattr(lib, "host_disc" + sfx)(
        mid, int(foh), disc_threads, *dims, *ptr,
        *[a.ctypes.data_as(P) for a in outs[:4]],
        None if prof is None else prof.ctypes.data) == 0
    outs = [torch.from_numpy(a) for a in outs[:4]]
    J = host_resim(lib, ins, foh, method)
    return (outs[0], outs[1], outs[2] if foh else None, outs[3]), J


def host_resim(lib, ins, foh, method, substeps=SUBSTEPS):
    """J of the host build of the resim body, (B,)."""
    X, U, t, par = [np.ascontiguousarray(a.numpy()) for a in ins]
    f32 = X.dtype == np.float32
    P = ctypes.POINTER(ctypes.c_float if f32 else ctypes.c_double)
    J = np.full(X.shape[0], np.nan, X.dtype)
    assert getattr(lib, "host_resim" + ("_f32" if f32 else ""))(
        disc_mono._METHODS.index(method), int(foh), X.shape[0],
        X.shape[1], U.shape[1], substeps,
        *[a.ctypes.data_as(P) for a in (X, U, t, par)],
        J.ctypes.data_as(P)) == 0
    return torch.from_numpy(J)


def rel(a, b):
    """max |a - b| relative to 1 + max |b|."""
    return float((a.double() - b).abs().max() / (1 + b.abs().max()))


def distances(got, ref):
    """Per output: A, B, C, z, J."""
    (disc_g, J_g), (disc_r, J_r) = got, ref
    names = ("A", "B", "C", "z")
    out = {nm: rel(g, r) for nm, g, r in zip(names, disc_g, disc_r)
           if r is not None}
    out["J"] = rel(J_g, J_r)
    return out


@pytest.mark.parametrize("foh,method", VARIANTS, ids=VARIANT_IDS)
def test_kernel_body_matches_plain(host_lib, foh, method):
    """Float64: the kernel body and the plain version differ only in the
    order of the matrix-vector sums, so they agree to 1e-10 relative."""
    got = host_run(host_lib, inputs(foh), foh, method)
    for g in got[0]:
        assert g is None or bool(torch.isfinite(g).all())
    d = distances(got, plain(foh, method))
    assert max(d.values()) <= 1e-10, d


# The main path's dtype: the kernel body in float32 must land within this
# of the float64 plain result (per output, max error relative to
# 1 + max |float64 value|), about four times the largest reading over the
# four variants, 4.0e-7 (J, FOH rk4; the plain version in float32 reads
# the same; see test_kernel_body_float32_near_float64 under -s).
F32_CEILING = 1.6e-6


@pytest.mark.parametrize("foh,method", VARIANTS, ids=VARIANT_IDS)
def test_kernel_body_float32_near_float64(host_lib, foh, method):
    ins32 = [a.float() for a in inputs(foh)]
    got = host_run(host_lib, ins32, foh, method)
    d = distances(got, plain(foh, method))
    args = (RocketQuat, *ins32, SUBSTEPS, method, foh)
    d_plain = distances((disc_mono._disc_plain(*args),
                         disc_mono._resim_plain(*args)), plain(foh, method))
    print(f"float32 distance from float64 plain, kernel body / plain: "
          + ", ".join(f"{k} {d[k]:.2e} / {d_plain[k]:.2e}" for k in d))
    assert max(d.values()) <= F32_CEILING, d


def turned(X, U, rng):
    """X, U (float64) turned and spun: quaternions moved by ~0.1 and
    renormalized, angular rates, lateral thrust and roll torque made
    nonzero (the initial guesses hold them at zero, so the rows that read
    the rotation are trivial there)."""
    X, U = X.clone(), U.clone()
    q = X[..., 7:11] + 0.1 * torch.tensor(rng.standard_normal(
        X[..., 7:11].shape))
    X[..., 7:11] = q / q.norm(dim=-1, keepdim=True)
    X[..., 11:14] = 1e-3 * torch.tensor(rng.standard_normal(
        X[..., 11:14].shape))
    t_ax = U[..., 2:3].abs()
    U[..., 0:2] = t_ax * 0.1 * torch.tensor(rng.standard_normal(
        U[..., 0:2].shape))
    U[..., 3:4] = t_ax * 1e-3 * torch.tensor(rng.standard_normal(
        U[..., 3:4].shape))
    return X, U


def first_scenario(foh):
    """inputs(foh) cut to its first scenario (4 intervals)."""
    return [a[:1].contiguous() for a in inputs(foh)]


@pytest.mark.parametrize("foh,method", VARIANTS, ids=VARIANT_IDS)
def test_kernel_body_independent_of_thread_count(host_lib, foh, method):
    """The discretize body at the kernel's own block against 32, 96 and
    128 threads: the x chain moves to another warp (at 32 threads, the warp
    of Y's columns) and the Jacobians and r rows to other threads, but
    every output keeps its arithmetic, so all agree bit for bit, in float64
    and float32."""
    for dtype in (F64, torch.float32):
        ins = [a.to(dtype) for a in first_scenario(foh)]
        ref = host_run(host_lib, ins, foh, method)[0]
        for nt in (32, 96, 128):
            got = host_run(host_lib, ins, foh, method, disc_threads=nt)[0]
            for g, r in zip(got, ref):
                assert (g is None) == (r is None)
                if r is not None:
                    assert bool(torch.isfinite(r).all())
                    assert torch.equal(g, r), (dtype, nt)


def resim_by_interval(lib, ins, foh, method, substeps=SUBSTEPS):
    """J (B,) of the host build of the resim body with every interval
    launched alone, as a scenario of two nodes (so at lane 0 of the first
    round, with t / (K - 1) as its time), the intervals' J added in
    interval order in the inputs' type."""
    X, U, t, par = ins
    B, K, n = X.shape
    KU = U.shape[1] - K + 2
    dt = t / (K - 1)
    Xs = torch.stack([X[:, k:k + 2] for k in range(K - 1)], 1)
    Us = torch.stack([U[:, k:k + KU] for k in range(K - 1)], 1)
    d = host_resim(lib, [Xs.reshape(-1, 2, n).contiguous(),
                         Us.reshape(-1, KU, U.shape[-1]).contiguous(),
                         dt.repeat_interleave(K - 1).contiguous(),
                         par.repeat_interleave(K - 1, 0).contiguous()],
                   foh, method, substeps).reshape(B, K - 1)
    J = torch.zeros(B, dtype=X.dtype)
    for k in range(K - 1):
        J = J + d[:, k]
    return J


@pytest.mark.parametrize("foh,method", VARIANTS, ids=VARIANT_IDS)
def test_resim_body_independent_of_layout(host_lib, foh, method):
    """The resim body's J against the same body run an interval at a time
    (each interval alone at lane 0 of a block, its J added in interval
    order): each row keeps its expression and every sum its order
    whatever lane an interval lands in, so the two agree bit for bit, in
    float64 and float32, on the initial guesses and on turned and
    spinning ones."""
    X, U, t, par = inputs(foh)
    Xt, Ut = turned(X, U, np.random.default_rng(7))
    for dtype in (F64, torch.float32):
        for case in ((X, U, t, par), (Xt, Ut.contiguous(), t, par)):
            ins = [a.to(dtype) for a in case]
            ref = host_resim(host_lib, ins, foh, method)
            assert bool(torch.isfinite(ref).all())
            got = resim_by_interval(host_lib, ins, foh, method)
            assert torch.equal(got, ref), dtype


@pytest.mark.parametrize("foh,method", VARIANTS, ids=VARIANT_IDS)
def test_resim_body_loops_over_intervals(host_lib, foh, method):
    """K - 1 = 40 intervals, more than a round's 32, and 10 substeps: J
    against the plain version in float64 to 1e-10, and bit for bit the
    same body run an interval at a time (intervals 32-39 at lanes 0-7 of
    a second round in the whole run)."""
    ins = inputs(foh, k=41)
    ref = disc_mono._resim_plain(RocketQuat, *ins, 10, method, foh)
    got = host_resim(host_lib, ins, foh, method, substeps=10)
    assert rel(got, ref) <= 1e-10, rel(got, ref)
    alone = resim_by_interval(host_lib, ins, foh, method, substeps=10)
    assert torch.equal(alone, got)


@pytest.mark.parametrize("dtype", [F64, torch.float32],
                         ids=["float64", "float32"])
def test_flow_parts_match_flow(host_lib, dtype):
    """Each row alone (row_u, row_x, as a resim thread evaluates it)
    against flow and against the value of flow on dual numbers, bit for
    bit on the host (which fuses no multiply-add), at random turned and
    spinning points (a quarter with a zero roll torque u3, whose
    angular-acceleration row 13 has a zero numerator); and flow against
    the model's flow_map in float64."""
    rng = np.random.default_rng(5)
    X, U, _, par = inputs(True)
    N = 64
    x, u = turned(X.reshape(-1, 14)[rng.integers(0, X.shape[0] * K, N)],
                  U.reshape(-1, 4)[rng.integers(0, U.shape[0] * K, N)], rng)
    u[::4, 3] = 0.0
    parN = par[rng.integers(0, 2, N)]
    ins = [np.ascontiguousarray(a.to(dtype).numpy()) for a in (x, u, parN)]
    outs = [np.full((N, 14), np.nan, ins[0].dtype) for _ in range(3)]
    P = ctypes.POINTER(ctypes.c_float if dtype == torch.float32
                       else ctypes.c_double)
    sfx = "_f32" if dtype == torch.float32 else ""
    assert getattr(host_lib, "host_flow_parts" + sfx)(
        N, *[a.ctypes.data_as(P) for a in ins + outs]) == 0
    f_flow, f_parts, f_dual = outs
    assert np.isfinite(f_flow).all()
    for other in (f_parts, f_dual):
        np.testing.assert_array_equal(other, f_flow)
    if dtype == F64:
        np.testing.assert_allclose(
            f_flow, RocketQuat.flow_map(x, u, parN).numpy(), rtol=1e-13,
            atol=1e-15)


def test_kernel_body_phase_counters(host_lib):
    """With a counter buffer each block records its three parts (x chain,
    Jacobians with r, Y recursion), its whole run in clock cycles and in
    nanoseconds; the parts never exceed the run; the outputs are those of
    a run without counters."""
    ins = first_scenario(True)
    slots = host_lib.host_disc_prof_slots()
    assert slots == 5
    prof = np.zeros((ins[0].shape[1] - 1, slots), np.int64)
    got = host_run(host_lib, ins, True, "dopri5", prof=prof)[0]
    ref = host_run(host_lib, ins, True, "dopri5")[0]
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert (prof[:, :3] > 0).all(), prof
    assert (prof[:, :3].sum(1) <= prof[:, 3]).all(), prof
    assert (prof[:, 4] > 0).all(), prof


def test_shared_memory_fits(host_lib):
    """The discretize block's shared memory (``disc_smem_bytes``, what the
    launcher gives it) fits an H100 block's 227 KB in every variant and
    type, and a double block takes more than a float one; the resim
    block's (``resim_smem_bytes``) fits the 48 KB a launch takes without
    opting in."""
    for foh, method in VARIANTS:
        mid = disc_mono._METHODS.index(method)
        f32, f64 = (host_lib.host_disc_smem_bytes(eb, mid, int(foh))
                    for eb in (4, 8))
        assert 0 < f32 < f64 <= 232448, (foh, method, f32, f64)
    r32, r64 = (host_lib.host_resim_smem_bytes(eb) for eb in (4, 8))
    assert 0 < r32 < r64 <= 48 * 1024, (r32, r64)


def test_dual_jacobian_matches_torch_func(host_lib):
    """f and [A | B] from the dual numbers against torch.func's jacfwd of
    the model at random points."""
    rng = np.random.default_rng(3)
    X, U, _, par = inputs(True)
    N = X.shape[0] * K
    x = X.reshape(-1, 14)[:N] * (1 + 0.2 * torch.tensor(
        rng.standard_normal((N, 14))))
    u = U.reshape(-1, 4)[:N] * (1 + 0.5 * torch.tensor(
        rng.standard_normal((N, 4))))
    parN = par[:1].expand(N, -1).contiguous()
    f_ref = RocketQuat.flow_map(x, u, parN)
    A_ref, B_ref = vmap(jacfwd(RocketQuat.flow_map, argnums=(0, 1)))(
        x, u, parN)
    J_ref = torch.cat([A_ref, B_ref], -1)
    f = np.zeros((N, 14))
    J = np.zeros((N, 14, 18))
    P = ctypes.POINTER(ctypes.c_double)
    host_lib.host_flow_jac(N, *(np.ascontiguousarray(a.numpy()).ctypes
                                .data_as(P) for a in (x, u, parN)),
                           f.ctypes.data_as(P), J.ctypes.data_as(P))
    np.testing.assert_allclose(f, f_ref.numpy(), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(J, J_ref.numpy(), rtol=1e-12, atol=1e-14)


def test_routing():
    """CPU tensors take the plain versions; a model without a CUDA flow map
    has no kernel."""
    X, U, t, par = inputs(True)
    td = TrajectoryData(X=X, U=U, t=t)
    dd = disc_mono.multiple_shooting_fused(RocketQuat, par, td,
                                           substeps=SUBSTEPS)
    assert torch.equal(dd.A, plain(True, "dopri5")[0][0])
    assert dd.s is None
    J = disc_mono.nonlinear_defect_cost_fused(RocketQuat, par, td,
                                              substeps=SUBSTEPS)
    assert torch.equal(J, plain(True, "dopri5")[1])

    class NoKernel:
        pass
    with pytest.raises(NotImplementedError):
        disc_mono._cuda_model(NoKernel)


def test_fused_scvx_matches_unfused():
    """solve_scvx with fuse_dynamics=True against False, both on the CPU
    in float64: the same math up to reassociation, held as the reference
    holds its own pair (tests/test_disc_mono.py)."""
    cfg = SCvxConfig(K=6, max_iterations=30, solve_budget=3,
                     change_threshold=1e-3, nondimensionalize=True,
                     substeps=3, sim_substeps=4,
                     solver=IPMSettings(iters=10, eps_reg=1e-4,
                                        eps_feas=1e-4, refine_steps=0,
                                        monolith=True))
    p = batch_params(RocketQuat.default_params(F64), 2)
    p = p.replace(x_init=p.x_init * torch.tensor([[1.0], [1.02]], dtype=F64))
    ref = solve_scvx(RocketQuat, p, cfg, device="cpu")
    got = solve_scvx(RocketQuat, p,
                     dataclasses.replace(cfg, fuse_dynamics=True),
                     device="cpu")
    np.testing.assert_allclose(got.td.U.numpy(), ref.td.U.numpy(),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.nonlinear_cost.numpy(),
                               ref.nonlinear_cost.numpy(), rtol=1e-4,
                               atol=1e-7)


# The card's kernels in float32 against the float64 plain version at
# these shapes; chip_smoke.py holds the main path's shapes to its own
# ceilings.
CARD_F32_CEILING = F32_CEILING


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernels_match_plain_on_card(dtype):
    """float64: kernel and plain version agree to 1e-10; float32: the
    kernel lands within CARD_F32_CEILING of the float64 plain result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from scpp_tpu_torch import kernels
    for foh, method in VARIANTS:
        ins = [a.to("cuda") for a in inputs(foh)]
        args = (RocketQuat, *ins, SUBSTEPS, method, foh)
        ref = (disc_mono._disc_plain(*args), disc_mono._resim_plain(*args))
        before = dict(kernels.launches)
        got_args = (RocketQuat, *[a.to(dtype) for a in ins], SUBSTEPS,
                    method, foh)
        got = (disc_mono._disc_cuda(*got_args),
               disc_mono._resim_cuda(*got_args))
        torch.cuda.synchronize()
        assert kernels.launches["disc_mono"] == before["disc_mono"] + 1
        assert kernels.launches["resim_mono"] == before["resim_mono"] + 1
        d = distances(got, ref)
        print(f"{dtype} {'foh' if foh else 'zoh'} {method}: " + ", ".join(
            f"{k} {v:.2e}" for k, v in d.items()))
        limit = 1e-10 if dtype == F64 else CARD_F32_CEILING
        assert max(d.values()) <= limit, d
