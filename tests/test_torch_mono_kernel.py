"""The monolithic IPM kernel against its plain version
(``ipm_mono._solve_block``), on the same inputs.

``scpp_tpu_torch/csrc/mono_ipm_body.cuh`` holds everything the kernel
computes; ``mono_ipm.cu`` only launches it. On the CPU the header is
compiled with g++ under the shim ``csrc/host_shim.h`` (``__device__``
and friends empty, each CUDA thread a ``std::thread`` with its own
``threadIdx``, ``__syncthreads`` a ``std::barrier``, ``__syncwarp`` one
per group of 32 threads) and run block by block, so the kernel's
arithmetic, its block-strided loops, its one-warp block factors and its
barriers are checked in float64 and float32 (the float instantiation
runs the register block factor, as on the card). The ``cuda`` test launches the real kernel and skips
without a GPU. This module imports no JAX, so it also runs on a machine
that has only the port's dependencies:
``python -m pytest tests/test_torch_mono_kernel.py --noconftest -q``.
"""

import ctypes
import functools
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from scpp_tpu_torch.algos.staged_problems import build_scvx_subproblem_staged
from scpp_tpu_torch.models import RocketQuat
from scpp_tpu_torch.models.base import batch_params
from scpp_tpu_torch.ops.discretization import multiple_shooting
from scpp_tpu_torch.solver import ipm_mono, mono_blocks
from scpp_tpu_torch.solver.ipm import IPMSettings

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scpp_tpu_torch", "csrc")

# Built twice in parallel, once per element type (HOST_F32 or not), and
# linked into one library: one instantiation per compiler halves the build.
HARNESS = r"""
#include "mono_ipm_body.cuh"
#include <thread>
#include <vector>

template <typename T>
int run_blocks(int nthreads, int B, int K, int w, int me, int l, int S,
               const int* socs, int iters, int refine, int track, int part,
               double eps_reg, double rho, double eps_feas, double step_frac,
               double kappa, T** in, T** out, long long* prof) {
  mono::Dims d;
  d.K = K; d.w = w; d.me = me; d.l = l; d.S = S;
  int off = l;
  for (int i = 0; i < S; ++i) {
    d.soc_off[i] = off; d.soc_q[i] = socs[i]; off += socs[i];
  }
  d.mc = off; d.Wp = w + me; d.iters = iters; d.refine_steps = refine;
  d.track_best = track; d.part = part; d.eps_reg = eps_reg; d.rho = rho;
  d.eps_feas = eps_feas; d.step_frac = step_frac; d.warm_kappa = kappa;
  d.nfac = mono::factor_tiles(w, me, nthreads, sizeof(T));
  const long long nw = (long long)K * w, ne = (long long)K * me,
                  nc = (long long)K * d.mc;
  std::vector<T> work(mono::workspace_elems(K, w, me, d.mc), NAN);
  const long long smem_n =
      mono::smem_elems(K, w, me, d.mc, nthreads, d.nfac, sizeof(T));
  // the launcher's check: the solve's ring needs a slot in the region
  if (cr::ring_slots(K, w + me, (smem_n - nthreads) * sizeof(T),
                     sizeof(T)) < 1)
    return -1;
  std::vector<T> smem(smem_n, NAN);
  blockDim.x = nthreads;
  mono::mono_smem = reinterpret_cast<unsigned char*>(smem.data());
  for (int b = 0; b < B; ++b) {
    std::barrier<> bar(nthreads);
    g_barrier = &bar;
    HostWarps warps(nthreads);
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; ++t) {
      threads.emplace_back([&, t]() {
        threadIdx.x = t;
        mono::Solver<T> s(
            d, work.data(), in[0] + b * 2 * w * ne,
            in[1] + b * 2 * w * nc, in[2] + b * ne, in[3] + b * nc,
            in[4] + b * nw, in[5] + b * ne, in[6] + b * nc, in[7] + b * nw);
        s.run(in[8] + b * 4, in[9] + b * nw, in[10] + b * ne,
              in[11] + b * nc, out[0] + b * nw, out[1] + b * ne,
              out[2] + b * nc, out[3] + b * nc, out[4] + b * 4,
              prof ? prof + b * mono::kProfSlots : nullptr);
      });
    }
    for (auto& th : threads) th.join();
  }
  return 0;
}

#define HOST_RUN(name, T)                                                  \
  extern "C" int name(int nthreads, int B, int K, int w, int me, int l,    \
                      int S, const int* socs, int iters, int refine,       \
                      int track, int part, double eps_reg, double rho,     \
                      double eps_feas, double step_frac, double kappa,     \
                      T** in, T** out, long long* prof) {                  \
    return run_blocks<T>(nthreads, B, K, w, me, l, S, socs, iters, refine, \
                         track, part, eps_reg, rho, eps_feas, step_frac,   \
                         kappa, in, out, prof);                            \
  }
#ifdef HOST_F32
HOST_RUN(host_run_f32, float)
#else
thread_local Dim3 threadIdx;
Dim3 blockDim;
std::barrier<>* g_barrier;
SpinBarrier** g_warp_barriers;
unsigned long long (*g_warp_xch)[2][32];
unsigned char* mono::mono_smem;
HOST_RUN(host_run, double)

// the ring slots that kernel 4's solve gets in the shared region of a
// kernel-1 block of `nthreads` threads in an `eb`-byte type
extern "C" int host_solve_slots(int K, int w, int me, int mc, int nthreads,
                                int eb) {
  const int nfac = mono::factor_tiles(w, me, nthreads, eb);
  const long long region =
      mono::smem_elems(K, w, me, mc, nthreads, nfac, eb) - nthreads;
  return cr::ring_slots(K, w + me, region * eb, eb);
}

// the warp's signed block factor alone, with `nthreads` <= 32 lanes:
// M (n, n) -> L, L^{-1}; `regs` runs the register version (n == 48 and
// 32 lanes, as the float kernel runs it), else the shared-tile one
extern "C" int host_chol(int nthreads, int w, int me, int regs,
                         const double* M, double* L, double* Linv) {
  const int n = w + me;
  if (regs && (n != mono::kRegN || nthreads != mono::kWarp)) return -1;
  std::vector<double> tile(mono::factor_tile_elems(n), NAN);
  blockDim.x = nthreads;
  std::barrier<> bar(nthreads);
  g_barrier = &bar;
  HostWarps warps(nthreads);
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t) {
    threads.emplace_back([&, t]() {
      threadIdx.x = t;
      if (regs)
        mono::warp_block_factor_reg(M, tile.data(), Linv, L, w, t);
      else
        mono::warp_block_factor_smem(M, tile.data(), Linv, L, n, w, t,
                                     nthreads);
    });
  }
  for (auto& th : threads) th.join();
  return 0;
}
#endif
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a C++20 compiler is needed to build the kernel body"
    d = tmp_path_factory.mktemp("mono_host")
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libmono_host.so"
    objs = [d / f"harness{i}.o" for i in range(2)]
    builds = [subprocess.Popen(
        [cxx, "-std=c++20", "-O1", "-c", "-fPIC", "-pthread", *flag,
         "-include", os.path.join(CSRC, "host_shim.h"), "-I", CSRC,
         "-o", str(o), str(d / "harness.cpp")], stderr=subprocess.PIPE)
        for o, flag in zip(objs, ([], ["-DHOST_F32"]))]
    for b in builds:
        _, err = b.communicate(timeout=120)
        assert b.returncode == 0, err.decode()
    subprocess.run([cxx, "-shared", "-pthread", "-o", str(lib),
                    *map(str, objs)], check=True, capture_output=True,
                   timeout=120)
    so = ctypes.CDLL(str(lib))
    for fn, c_t in ((so.host_run, ctypes.c_double),
                    (so.host_run_f32, ctypes.c_float)):
        fn.argtypes = ([ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
                       + [ctypes.c_int] * 4 + [ctypes.c_double] * 5
                       + [ctypes.POINTER(ctypes.POINTER(c_t))] * 2
                       + [ctypes.c_void_p])
    P = ctypes.POINTER(ctypes.c_double)
    so.host_chol.argtypes = [ctypes.c_int] * 4 + [P] * 3
    so.host_solve_slots.argtypes = [ctypes.c_int] * 6
    return so


def breakdown_block(w, me, broken, seed=5, spread=1.0):
    """A quasidefinite block L S L^T with the pivots of the ``broken``
    columns given the wrong sign; ``spread`` scales L's off-diagonal
    entries."""
    n = w + me
    rng = np.random.default_rng(seed)
    Lt = (np.tril(spread * rng.standard_normal((n, n)), -1)
          + np.diag(1 + rng.random(n)))
    sig = np.array([1.0] * w + [-1.0] * me)
    M = (Lt * sig) @ Lt.T
    for j in broken:
        M[j, j] -= sig[j] * 2 * Lt[j, j] ** 2
    return M


def host_solve(lib, statics, ins, nthreads, part="full", prof=None):
    K, w, me, l, socs, st = statics
    mc = l + sum(socs)
    B = ins[0].shape[0]
    f32 = ins[0].dtype == torch.float32
    ins = [np.ascontiguousarray(t.numpy()) for t in ins]
    outs = [np.zeros((B,) + s, ins[0].dtype) for s in
            ((K, w), (K, me), (K, mc), (K, mc), (1, 4))]
    P = ctypes.POINTER(ctypes.c_float if f32 else ctypes.c_double)
    err = (lib.host_run_f32 if f32 else lib.host_run)(nthreads, B, K, w, me, l, len(socs),
                 (ctypes.c_int * len(socs))(*socs), st.iters,
                 st.refine_steps, int(st.mono_track_best),
                 ipm_mono.part_code(part), st.eps_reg,
                 st.rho_lift, st.eps_feas, st.step_frac, st.warm_kappa,
                 (P * 12)(*[a.ctypes.data_as(P) for a in ins]),
                 (P * 5)(*[a.ctypes.data_as(P) for a in outs]),
                 None if prof is None else prof.ctypes.data)
    assert err == 0
    return [torch.from_numpy(o) for o in outs]


def rocketquat_inputs(settings, warm, K=5):
    """_prep's inputs for the step-0 subproblems of two dispersed
    RocketQuat scenarios of K stages (float64)."""
    p = batch_params(RocketQuat.default_params(torch.float64), 2)
    p = p.replace(x_init=p.x_init * torch.tensor([[1.0], [1.02]],
                                                 dtype=torch.float64))
    p = RocketQuat.nondimensionalize(p)
    td = RocketQuat.init_trajectory(p, K, True)
    dd = multiple_shooting(RocketQuat, RocketQuat.param_vector(p), td,
                           substeps=2)
    prog = build_scvx_subproblem_staged(
        RocketQuat, p, td, dd, torch.full((2,), 5.0, dtype=torch.float64),
        1e3, RocketQuat.constraint_ref(p, td))
    f = dict(dtype=torch.float64)
    rng = np.random.default_rng(4)
    if warm:
        w = [torch.tensor(0.1 * rng.standard_normal((2, K, n)))
             for n in (prog.w, prog.me)]
        w.append(torch.tensor(rng.random((2, K, prog.mc))))
    else:
        w = [torch.zeros((2, K, n), **f) for n in (prog.w, prog.me, prog.mc)]
    ins, _ = ipm_mono._prep(prog, settings, *w,
                            torch.full((2,), warm, dtype=torch.bool))
    statics = (prog.K, prog.w, prog.me, prog.l, tuple(prog.soc_sizes),
               settings)
    return statics, ins


FLAGSHIP = IPMSettings(iters=10, eps_reg=1e-4, eps_feas=1e-4,
                       refine_steps=0, monolith=True)


@pytest.mark.parametrize("case", [
    ("cold", FLAGSHIP, 1), ("warm", FLAGSHIP, 8),
    ("refine", FLAGSHIP.replace(refine_steps=1, iters=6), 8),
    ("last_iterate", FLAGSHIP.replace(mono_track_best=False, iters=7), 4)],
    ids=lambda c: f"{c[0]}-{c[2]}threads")
def test_kernel_body_matches_plain(host_lib, case):
    """Float64 agreement to 1e-6 relative, as chip_smoke.py asks of the
    kernel on the card: the thread count changes the order of the block
    reductions, and 6-10 IPM iterations amplify that rounding to ~1e-9."""
    name, settings, nthreads = case
    statics, ins = rocketquat_inputs(settings, warm=name == "warm")
    ref = ipm_mono._solve_block(statics, *ins)
    got = host_solve(host_lib, statics, ins, nthreads)
    for a, b in zip(got[:4], ref[:4]):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 1e-6 * (1 + float(
            b.abs().max()))
    np.testing.assert_array_equal(got[4][:, 0, 1].numpy(),
                                  ref[4][:, 0, 1].numpy())
    np.testing.assert_allclose(got[4][:, 0, 0].numpy(),
                               ref[4][:, 0, 0].numpy(), rtol=1e-6)


@functools.lru_cache(maxsize=None)
def capped_inputs():
    """The cold programs of the parts test, with ``settings.iters`` 1."""
    return rocketquat_inputs(FLAGSHIP.replace(iters=1), warm=False)


@pytest.mark.parametrize("part", ["init", "iter1", "iter2"])
def test_kernel_body_parts_match_plain(host_lib, part):
    """The ``part`` hook of the kernel body against the plain version's,
    on the cold K=5 programs with 8 threads, float64 to 1e-6 relative as
    above: the starting point and a zero diag (init), exactly N
    iterations with the per-scenario count (iterN, past the settings'
    cap: iters=1 here). The whole solve, part code -1, is what
    ``host_solve`` runs by default in the tests above."""
    statics, ins = capped_inputs()
    ref = ipm_mono._solve_block(statics, *ins, part=part)
    got = host_solve(host_lib, statics, ins, 8, part)
    for a, b in zip(got[:4], ref[:4]):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 1e-6 * (1 + float(
            b.abs().max()))
    np.testing.assert_array_equal(got[4][:, 0, 1].numpy(),
                                  ref[4][:, 0, 1].numpy())
    np.testing.assert_allclose(got[4][:, 0, 0].numpy(),
                               ref[4][:, 0, 0].numpy(), rtol=1e-6)
    if part == "init":
        assert not got[4].any()
    else:
        np.testing.assert_array_equal(got[4][:, 0, 1].numpy(),
                                      [int(part[4:])] * 2)


# The kernel body and the plain version factor the KKT system by cyclic
# reduction in the same order, so on the parts they agree to rounding:
# float64 to 1e-10 relative, at two thread counts (the kernel's 512, 16
# warps and 15 block factors at once; and 64, 2 warps, so the 15 odd
# blocks of a level are factored 2 at a time) and two K: 5 (blocks 5, 3,
# 2: odd and even levels, an odd count of levels) and 9 (9, 5, 3, 2: an
# even count of levels, so the root's blocks end in the other buffer).
# 512 host threads cost seconds a part, so they run one part per K.
CR_CASES = [(5, 64, "init"), (5, 64, "iter1"), (5, 64, "iter2"),
            (5, 512, "iter1"), (9, 64, "iter1"), (9, 512, "init")]


@functools.lru_cache(maxsize=None)
def k_inputs(K):
    """Cold programs of K stages, with ``settings.iters`` 1."""
    return rocketquat_inputs(FLAGSHIP.replace(iters=1), warm=False, K=K)


@pytest.mark.parametrize("K,nthreads,part", CR_CASES,
                         ids=[f"K{k}-{n}threads-{p}" for k, n, p in CR_CASES])
def test_kernel_body_matches_plain_to_1e10(host_lib, K, nthreads, part):
    statics, ins = k_inputs(K)
    ref = ipm_mono._solve_block(statics, *ins, part=part)
    got = host_solve(host_lib, statics, ins, nthreads, part)
    for a, b in zip(got[:4], ref[:4]):
        assert float((a - b).abs().max()) <= 1e-10 * (1 + float(
            b.abs().max()))
    np.testing.assert_array_equal(got[4][:, 0, 1].numpy(),
                                  ref[4][:, 0, 1].numpy())


def test_kernel_body_phase_counters(host_lib):
    """With a counter buffer the body records every phase (on the host,
    clock64() reads nanoseconds) and computes the same solution bit for
    bit: the phases sum to the block's whole run, and the initialization
    and the iteration's KKT phases, kernel 4's solve among them, are not
    empty."""
    statics, ins = k_inputs(5)
    prof = np.zeros((2, ipm_mono.PROF_SLOTS), np.int64)
    got = host_solve(host_lib, statics, ins, 64, "iter1", prof)
    plain = host_solve(host_lib, statics, ins, 64, "iter1")
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    n = len(ipm_mono.PHASES)
    phases = prof[:, :n]
    assert (phases >= 0).all()
    names = ipm_mono.PHASES
    for name in ("init", "residuals", "assembly", "block_factors",
                 "level_products", "kkt_solves", "cr_solve", "cone_step"):
        assert (phases[:, names.index(name)] > 0).all(), name
    total = prof[:, n]
    assert (phases.sum(1) <= total).all()
    assert (phases.sum(1) >= 0.95 * total).all()
    # the host's clock64() and globaltimer are one clock, read in turn
    np.testing.assert_allclose(prof[:, n + 1], total, rtol=1e-2)


def random_inputs(B, K, w, me, l, socs, seed):
    """The kernel's 12 inputs drawn uniformly from [0, 1) in float64, as
    diag/mono_parts.py draws them, for programs of any shape."""
    mc = l + sum(socs)
    rng = np.random.default_rng(seed)
    shapes = [(B, K, 2 * w, me), (B, K, 2 * w, mc), (B, K, me), (B, K, mc),
              (B, K, w), (B, K, me), (B, K, mc), (B, K, w), (B, 1, 4),
              (B, K, w), (B, K, me), (B, K, mc)]
    return [torch.tensor(rng.random(s)) for s in shapes]


@pytest.mark.parametrize("eb", [8, 4], ids=["float64", "float32"])
def test_solve_region_holds_a_ring_slot(host_lib, eb):
    """Kernel 1's shared region holds at least one ring slot of kernel 4's
    solve in the kernel's own element type, at every thread count, and
    where the solve sizes the region: at K=30, w=46, me=16, mc=52 a region
    sized by the float count of one slot is 32 bytes short of a double
    slot."""
    for K in (2, 3, 4, 5, 9, 16, 30, 33):
        for w in (1, 2, 3, 5, 8, 13, 32, 46, 64):
            for me in (1, 2, 3, 7, 16, 24):
                for mc in (1, me, 52, 2 * w + me):
                    for nthreads in (1, 8, 64, 512):
                        assert host_lib.host_solve_slots(
                            K, w, me, mc, nthreads, eb) >= 1, \
                            (K, w, me, mc, nthreads)


# (K, w, me, l, socs, threads): small programs whose shared region the
# solve sizes, where one double slot outgrows the float count of one
SOLVE_SIZED = [(5, 3, 2, 2, (3,), 8), (4, 4, 2, 2, (3,), 64),
               (7, 3, 1, 2, (3,), 8)]


@pytest.mark.parametrize("K,w,me,l,socs,nthreads", SOLVE_SIZED,
                         ids=[f"K{c[0]}-w{c[1]}-me{c[2]}-{c[5]}threads"
                              for c in SOLVE_SIZED])
def test_kernel_body_where_the_solve_sizes_the_region(host_lib, K, w, me, l,
                                                      socs, nthreads):
    """Kernel 1's body in float64 on random programs of such a shape
    against the plain version, 1e-10 relative after one iteration and
    1e-8 after the whole solve: every KKT solve runs."""
    st = FLAGSHIP.replace(iters=4)
    statics = (K, w, me, l, socs, st)
    ins = random_inputs(2, K, w, me, l, socs, seed=K + w)
    for part, tol in (("iter1", 1e-10), ("full", 1e-8)):
        ref = ipm_mono._solve_block(statics, *ins, part=part)
        got = host_solve(host_lib, statics, ins, nthreads, part)
        for a, b in zip(got[:4], ref[:4]):
            assert torch.isfinite(a).all()
            assert float((a - b).abs().max()) <= tol * (1 + float(
                b.abs().max())), part


# The main path's dtype: the kernel in float32 must land within this of
# the float64 plain solution (max error over x/y/s/z relative to
# 1 + max|float64 value|) on the cold K=5 programs below, about four times
# the largest reading of the kernel body on the CPU (5.0e-4 with one
# thread, 2.8e-4 with eight; the plain version in float32: 8.9e-5;
# test_kernel_body_float32_near_float64 prints them under -s).
F32_CEILING = 2e-3


def float32_distance(out32, ref64):
    return max(float((a.double() - b).abs().max() / (1 + b.abs().max()))
               for a, b in zip(out32[:4], ref64[:4]))


@pytest.mark.parametrize("nthreads", [1, 8])
def test_kernel_body_float32_near_float64(host_lib, nthreads):
    """The kernel body instantiated in float32 against the plain float64
    solution, with the same per-scenario iteration counts."""
    statics, ins = rocketquat_inputs(FLAGSHIP, warm=False)
    ref = ipm_mono._solve_block(statics, *ins)
    ins32 = [t.float() for t in ins]
    got = host_solve(host_lib, statics, ins32, nthreads)
    assert all(bool(torch.isfinite(a).all()) for a in got[:4])
    dist = float32_distance(got, ref)
    print(f"float32 distance from the float64 plain solution: kernel body "
          f"{dist:.2e}, plain version "
          f"{float32_distance(ipm_mono._solve_block(statics, *ins32), ref):.2e}")
    assert dist <= F32_CEILING
    np.testing.assert_array_equal(got[4][:, 0, 1].numpy(),
                                  ref[4][:, 0, 1].numpy())


def check_block_factor(host_lib, w, me, seed, broken, nthreads, regs,
                       spread=1.0):
    M = breakdown_block(w, me, broken, seed, spread)
    L_ref, Linv_ref = (a[0].numpy() for a in mono_blocks.signed_chol_inv(
        torch.tensor(M[None]), w))
    L, Linv = np.full_like(M, np.inf), np.full_like(M, np.inf)
    P = ctypes.POINTER(ctypes.c_double)
    assert host_lib.host_chol(nthreads, w, me, regs, *(
        np.ascontiguousarray(a).ctypes.data_as(P) for a in (M, L, Linv))) == 0
    if np.isfinite(L_ref).all():
        np.testing.assert_allclose(L, L_ref, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(Linv, Linv_ref, rtol=1e-9, atol=1e-12)
    else:
        # only L^{-1} leaves the factor: NaN as a whole, as the plain one
        assert not np.isfinite(L).all()
        assert np.isnan(Linv).all() and np.isnan(Linv_ref).all()


def factor_case_id(v):
    if isinstance(v, int):
        return str(v)
    return "cols" + "-".join(map(str, v)) if v else "intact"


# The same after two iterations, where the float32 body takes the card's
# block factor once its warps are full: about four times the largest
# reading on the cold K=5 programs (1.71e-5 with 8 threads, the
# shared-tile factor; 1.68e-5 with 64, the register one; the plain
# version in float32: 1.72e-5).
F32_PART_CEILING = 7e-5


@pytest.mark.parametrize("nthreads,part", [(64, "iter2"), (8, "iter2")])
def test_kernel_body_float32_parts_near_float64(host_lib, nthreads, part):
    """The float32 body's parts against the plain float64 ones. With 64
    threads (full warps) every 48 x 48 block factor is the register one,
    as in the float kernel on the card; with 8 the shared-tile one."""
    statics, ins = k_inputs(5)
    ref = ipm_mono._solve_block(statics, *ins, part=part)
    got = host_solve(host_lib, statics, [t.float() for t in ins], nthreads,
                     part)
    assert all(bool(torch.isfinite(a).all()) for a in got[:4])
    assert float32_distance(got, ref) <= F32_PART_CEILING
    np.testing.assert_array_equal(got[4][:, 0, 1].numpy(),
                                  ref[4][:, 0, 1].numpy())


@pytest.mark.parametrize("seed,broken", [
    (5, ()), (7, (7,)), (7, (15,)), (5, (20,)), (5, (12,)), (5, (3, 19))],
    ids=factor_case_id)
def test_kernel_factor_floors_pivots_as_plain(host_lib, seed, broken):
    """The kernel's signed block factor in its shared tile
    (``warp_block_factor_smem``, with 8 lanes) against the plain one
    (``mono_blocks.signed_chol_inv``) on blocks with wrong-sign pivots
    (the cases that test_torch_ipm_mono.py holds against the reference):
    the same floor and panels, the same huge finite factors, NaN where it
    overflows."""
    check_block_factor(host_lib, 16, 8, seed, broken, 8, regs=0)


# 48 x 48 blocks (w=32, me=16, the flagship's), with L's off-diagonal
# entries scaled by 0.25: at 48 columns unscaled normal entries make L^{-1}
# reach ~3e3, and the plain factor's panel sums and the kernel's rank-1
# updates then part at ~1e-7 relative (both kernel factors alike, 8e-14
# from each other). A wrong-sign pivot gives finite factors up to ~1e224
# or, at column 40 or at columns 3 and 19, an overflow.
@pytest.mark.parametrize("regs", [1, 0], ids=["registers", "shared"])
@pytest.mark.parametrize("seed,broken", [
    (5, ()), (7, (7,)), (5, (20,)), (5, (31,)), (7, (38,)), (5, (45,)),
    (5, (47,)), (5, (20, 44)), (5, (40,)), (7, (3, 19))],
    ids=factor_case_id)
def test_kernel_factor_floors_pivots_as_plain_48(host_lib, seed, broken,
                                                 regs):
    """Both block factors with a full warp at the flagship's block size:
    the register one (``warp_block_factor_reg``, which the float kernel
    runs on every 48 x 48 block: its own floor, its ``__any_sync``
    overflow vote and its reciprocal row scaling) and the shared-tile one
    (which the double kernel runs), against the plain factor as above."""
    check_block_factor(host_lib, 32, 16, seed, broken, 32, regs,
                       spread=0.25)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_on_card(dtype):
    """float64: kernel and plain version agree to 1e-6 with the same
    iteration counts. float32: the kernel lands within F32_CEILING of the
    float64 plain solution."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from scpp_tpu_torch import kernels
    statics, ins = rocketquat_inputs(FLAGSHIP, warm=False)
    ins64 = [t.to("cuda") for t in ins]
    ref64 = ipm_mono._solve_block(statics, *ins64)
    before = kernels.launches["mono_ipm"]
    got = ipm_mono.mono_solve(statics, *[t.to(dtype) for t in ins64])
    assert kernels.launches["mono_ipm"] == before + 1
    if dtype == torch.float64:
        for a, b in zip(got[:4], ref64[:4]):
            assert float((a - b).abs().max()) <= 1e-6 * (1 + float(
                b.abs().max()))
        assert torch.equal(got[4][:, 0, 1], ref64[4][:, 0, 1])
        return
    assert all(bool(torch.isfinite(a).all()) for a in got[:4])
    dist = float32_distance(got, ref64)
    print(f"float32 kernel distance from the float64 plain solution {dist:.2e}")
    assert dist <= F32_CEILING


@pytest.mark.cuda
@pytest.mark.parametrize("part", ["init", "iter1", "iter2"])
def test_kernel_parts_match_plain_on_card(part):
    """The ``part`` launch against the plain version's part in float64
    (1e-6, the same counts), and ``part="full"`` bit for bit the default
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from scpp_tpu_torch import kernels
    statics, ins = rocketquat_inputs(FLAGSHIP, warm=False)
    ins = [t.to("cuda") for t in ins]
    ref = ipm_mono._solve_block(statics, *ins, part=part)
    before = kernels.launches["mono_ipm"]
    got = ipm_mono.mono_solve(statics, *ins, part=part)
    assert kernels.launches["mono_ipm"] == before + 1
    for a, b in zip(got[:4], ref[:4]):
        assert float((a - b).abs().max()) <= 1e-6 * (1 + float(
            b.abs().max()))
    assert torch.equal(got[4][:, 0, 1], ref[4][:, 0, 1])
    default = ipm_mono.mono_solve(statics, *ins)
    full = ipm_mono.mono_solve(statics, *ins, part="full")
    assert all(torch.equal(a, b) for a, b in zip(default, full))


@pytest.mark.cuda
def test_phase_counters_sum_to_the_launch():
    """The counters on the card: each block's phases sum to its whole run
    (converted by its globaltimer reading), the slowest block's run is
    the launch within 5% (CUDA events; the blocks of one launch run at
    once), and counting moves the launch by less than 2%."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from scpp_tpu_torch.diag import mono_parts
    statics, ins = mono_parts.statics(6), mono_parts.inputs()
    split, ms_off, ms_on = mono_parts.profile(statics, ins)
    mono_parts.print_split("mono_ipm B=16 K=30", split, ms_off, ms_on)
    assert abs(split["sum"][1] / split["block"][1] - 1) <= 0.01
    assert abs(split["block"][1] / ms_on - 1) <= 0.05
    assert abs(ms_on / ms_off - 1) <= 0.02
