"""The cyclic-reduction KKT solve kernel against its plain version
(``staged_kkt.cr_solve``), on the same factors.

``scpp_tpu_torch/csrc/cr_solve_body.cuh`` holds everything the kernel
computes; ``cr_solve.cu`` only launches it. On the CPU the header is
compiled with g++ under ``csrc/host_shim.h`` (each CUDA thread a
``std::thread``, ``__syncthreads`` a barrier) and run block by block, so
the kernel's arithmetic, its work split and its barriers are checked
here in float64 and float32; the ``cuda`` test launches the real kernel
and skips without a GPU. The plain version is held against the JAX
package in test_torch_staged_kkt.py. This module imports no JAX:
``python -m pytest tests/test_torch_cr_kernel.py --noconftest -q``.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from scpp_tpu_torch import kernels
from scpp_tpu_torch.solver import cr_fused
from scpp_tpu_torch.solver.staged_kkt import cr_factor, cr_solve, level_sizes

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scpp_tpu_torch", "csrc")

HARNESS = r"""
#include "cr_solve_body.cuh"
#include <thread>
#include <vector>

thread_local Dim3 threadIdx;
Dim3 blockDim;
std::barrier<>* g_barrier;

// the blocks one after another, each with `budget` bytes of shared memory
// (filled with NaN bytes first)
template <typename T>
int run(int nthreads, int B, int K, int Wp, int p, long long budget,
        const T* blocks, const T* root, const T* b, T* x) {
  if (cr::ring_slots(K, Wp, budget, sizeof(T)) < 1) return -1;
  std::vector<unsigned long long> smem((budget + 7) / 8, ~0ULL);
  const long long WW = (long long)Wp * Wp;
  blockDim.x = nthreads;
  for (int s = 0; s < B; ++s) {
    std::barrier<> bar(nthreads);
    g_barrier = &bar;
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; ++t) {
      threads.emplace_back([&, t]() {
        threadIdx.x = t;
        cr::solve<T>(K, Wp, p, blocks + s * (K - 1) * 3 * WW, root + s * WW,
                     b + (long long)s * K * Wp, x + (long long)s * K * Wp,
                     smem.data(), budget, false);
      });
    }
    for (auto& th : threads) th.join();
  }
  return 0;
}

extern "C" int host_cr(int nthreads, int B, int K, int Wp, int p,
                       long long budget, const double* blocks,
                       const double* root, const double* b, double* x) {
  return run<double>(nthreads, B, K, Wp, p, budget, blocks, root, b, x);
}
extern "C" int host_cr_f32(int nthreads, int B, int K, int Wp, int p,
                           long long budget, const float* blocks,
                           const float* root, const float* b, float* x) {
  return run<float>(nthreads, B, K, Wp, p, budget, blocks, root, b, x);
}
extern "C" long long host_smem_bytes(int K, int Wp, int slots, int eb) {
  return cr::smem_bytes(K, Wp, slots, eb);
}
extern "C" int host_ring_slots(int K, int Wp, long long budget, int eb) {
  return cr::ring_slots(K, Wp, budget, eb);
}
"""

# The float32 kernel must land within this of the float64 plain solution
# (max |error| relative to 1 + max |x|), about four times the largest
# reading of the kernel body here (test_kernel_body_float32_near_float64:
# 6.2e-8 at K=5 and 1.4e-7 at K=30, the plain version in float32 the same;
# they print under -s).
F32_CEILING = 6e-7


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a C++20 compiler is needed to build the kernel body"
    d = tmp_path_factory.mktemp("cr_host")
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libcr_host.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-include", os.path.join(CSRC, "host_shim.h"), "-I",
                    CSRC, "-o", str(lib), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    for fn, c_t in ((so.host_cr, ctypes.c_double),
                    (so.host_cr_f32, ctypes.c_float)):
        fn.argtypes = ([ctypes.c_int] * 5 + [ctypes.c_longlong]
                       + [ctypes.POINTER(c_t)] * 4)
    so.host_smem_bytes.argtypes = [ctypes.c_int] * 4
    so.host_smem_bytes.restype = ctypes.c_longlong
    so.host_ring_slots.argtypes = [ctypes.c_int] * 2 + [ctypes.c_longlong,
                                                        ctypes.c_int]
    return so


def qd_blocks(rng, B, K, p, q):
    """Blocks (D, O) of B random quasidefinite block-tridiagonal KKT
    matrices [[H + I, A'], [A, -I]] of banded least-squares problems, the
    structure the IPM emits (as test_staged_kkt's generator builds them,
    without the dense matrix). D (B, K, w, w), O (B, K-1, w, w)."""
    w = p + q
    Gb = rng.standard_normal((B, K, 3 * p, 2 * p)) * 0.7
    Gb[:, -1, :, p:] = 0.0
    Ab = rng.standard_normal((B, K, q, 2 * p)) * 0.8
    Ab[:, -1, :, p:] = 0.0
    H = np.einsum("bkra,bkrc->bkac", Gb, Gb)
    D = np.zeros((B, K, w, w))
    D[:, :, :p, :p] = H[:, :, :p, :p] + np.eye(p)
    D[:, 1:, :p, :p] += H[:, :-1, p:, p:]
    D[:, :, p:, :p] = Ab[:, :, :, :p]
    D[:, :, :p, p:] = np.swapaxes(Ab[:, :, :, :p], -1, -2)
    D[:, :, p:, p:] = -np.eye(q)
    O = np.zeros((B, K - 1, w, w))
    O[:, :, :p, :p] = H[:, :-1, p:, :p]
    O[:, :, :p, p:] = np.swapaxes(Ab[:, :-1, :, p:], -1, -2)
    return torch.tensor(D), torch.tensor(O)


def packed_case(B, K, p, q, seed, dtype=torch.float64):
    """A packed factor and a right-hand side; the factor is computed in
    ``dtype`` from float64 blocks."""
    rng = np.random.default_rng(seed)
    D, O = qd_blocks(rng, B, K, p, q)
    b = torch.tensor(rng.standard_normal((B, K, p + q)))
    fact = cr_factor(D.to(dtype), O.to(dtype), p)
    return cr_fused.cr_pack(fact), b, (D, O)


def host_solve(lib, packed, b, nthreads, slots=None):
    """The host-built body on ``packed`` and b, with the kernel's full
    shared-memory budget or with one of ``slots`` ring slots."""
    blocks, root, p = packed
    Bn, K, Wp = b.shape
    f32 = b.dtype == torch.float32
    budget = (cr_fused.SMEM_BUDGET if slots is None else
              lib.host_smem_bytes(K, Wp, slots, b.element_size()))
    arrs = [np.ascontiguousarray(t.numpy()) for t in (blocks, root, b)]
    x = np.full_like(arrs[2], np.nan)
    P = ctypes.POINTER(ctypes.c_float if f32 else ctypes.c_double)
    err = (lib.host_cr_f32 if f32 else lib.host_cr)(
        nthreads, Bn, K, Wp, p, budget,
        *(a.ctypes.data_as(P) for a in arrs + [x]))
    assert err == 0
    return torch.from_numpy(x)


def rel(a, b):
    return float((a.double() - b).abs().max() / (1 + b.abs().max()))


CASES = [(1, 3, 2, 32), (2, 3, 2, 1), (5, 4, 3, 8), (8, 6, 3, 32),
         (30, 6, 4, 64)]


@pytest.mark.parametrize("K,p,q,nthreads", CASES,
                         ids=[f"K{c[0]}-p{c[1]}-q{c[2]}-{c[3]}threads"
                              for c in CASES])
def test_kernel_body_matches_plain(host_lib, K, p, q, nthreads):
    """Float64 agreement to 1e-10 relative: the two differ only in the
    order of the Wp-term sums."""
    packed, b, _ = packed_case(3, K, p, q, seed=K)
    ref = cr_solve(cr_fused.cr_unpack(packed), b)
    got = host_solve(host_lib, packed, b, nthreads)
    assert torch.isfinite(got).all()
    assert rel(got, ref) <= 1e-10


@pytest.mark.parametrize("K", [5, 30])
def test_kernel_body_float32_near_float64(host_lib, K):
    """The kernel body in float32, on a float32 factor, against the
    float64 plain solution."""
    packed64, b, (D, O) = packed_case(2, K, 6, 4, seed=K + 1)
    ref = cr_solve(cr_fused.cr_unpack(packed64), b)
    packed32 = cr_fused.cr_pack(cr_factor(D.float(), O.float(), 6))
    got = host_solve(host_lib, packed32, b.float(), 16)
    plain = cr_solve(cr_fused.cr_unpack(packed32), b.float())
    print(f"float32 distance from the float64 plain solution at K={K}: "
          f"kernel body {rel(got, ref):.2e}, plain version "
          f"{rel(plain, ref):.2e}")
    assert rel(got, ref) <= F32_CEILING


# (K, p, q, threads): the ring cycles at K=30; bulk copies and 16-byte
# row reads where a row is a 16-byte multiple (Wp=8 and 40 in both types,
# Wp=6 in float64), element copies and 4- or 8-byte reads elsewhere
# (Wp=5); at K=40 the full ring stops at its 31 slots
RING_CASES = [(30, 4, 2, 32), (13, 5, 3, 8), (8, 3, 2, 1), (9, 26, 14, 64),
              (40, 4, 2, 32)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("K,p,q,nthreads", RING_CASES,
                         ids=[f"K{c[0]}-p{c[1]}-q{c[2]}-{c[3]}threads"
                              for c in RING_CASES])
def test_ring_depth_leaves_the_result_unchanged(host_lib, K, p, q, nthreads,
                                                dtype):
    """The kernel's budget sizes its ring of factor slots; at 1, 2 and 3
    slots (one block a chunk, the ring reloaded for the up-sweep) the
    body gives the same x bit for bit as at the full budget (every block
    resident), and float64 lands within 1e-10 of the plain version."""
    packed64, b, (D, O) = packed_case(2, K, p, q, seed=K + 5)
    if dtype == torch.float64:
        packed = packed64
    else:
        packed = cr_fused.cr_pack(cr_factor(D.float(), O.float(), p))
    b = b.to(dtype)
    full = host_solve(host_lib, packed, b, nthreads)
    assert torch.isfinite(full).all()
    for slots in (1, 2, 3):
        assert torch.equal(host_solve(host_lib, packed, b, nthreads, slots),
                           full), slots
    if dtype == torch.float64:
        assert rel(full, cr_solve(cr_fused.cr_unpack(packed), b)) <= 1e-10


def test_shared_memory_layout(host_lib):
    """The body's layout (``cr::smem_bytes``, ``cr::ring_slots``, which
    the wrapper reads from the built kernel): a slot more costs one slot's
    bytes, the ring takes as many slots as the budget holds, at most
    K - 1 and 31, and a budget below one slot is refused (the launcher
    returns cudaErrorInvalidValue, the host harness -1)."""
    for K, Wp, eb in ((30, 48, 4), (30, 48, 8), (5, 10, 4), (1, 7, 8),
                      (2, 5, 4), (40, 3, 8), (30, 62, 8)):
        one = host_lib.host_smem_bytes(K, Wp, 1, eb)
        slot = host_lib.host_smem_bytes(K, Wp, 2, eb) - one
        assert slot >= 3 * Wp * Wp * eb
        for budget, slots in ((one - 1, 0), (one, 1), (one + slot - 1, 1),
                              (1 << 40, min(max(K - 1, 1), 31))):
            assert host_lib.host_ring_slots(K, Wp, budget, eb) == slots
    # the flagship: 7 float slots and 3 double ones in 227 KB
    assert host_lib.host_ring_slots(30, 48, cr_fused.SMEM_BUDGET, 4) == 7
    assert host_lib.host_ring_slots(30, 48, cr_fused.SMEM_BUDGET, 8) == 3
    packed, b, _ = packed_case(1, 4, 2, 1, seed=0)
    budget = host_lib.host_smem_bytes(4, 3, 1, 8) - 1
    P = ctypes.POINTER(ctypes.c_double)
    arrs = [np.ascontiguousarray(t.numpy()) for t in (*packed[:2], b)]
    x = np.zeros_like(arrs[2])
    assert host_lib.host_cr(1, 1, 4, 3, 2, budget, *(
        a.ctypes.data_as(P) for a in arrs + [x])) == -1


def test_cpu_tensors_take_the_plain_version():
    kernels.reset_launches()
    packed, b, _ = packed_case(2, 7, 3, 2, seed=3)
    x = cr_fused.cr_solve_single(packed, b)
    assert torch.equal(x, cr_solve(cr_fused.cr_unpack(packed), b))
    assert kernels.launches["cr_solve"] == 0


def test_pack_round_trip():
    """The packed buffer holds each level's blocks once, in level order,
    and unpacks to the factor's own blocks."""
    rng = np.random.default_rng(0)
    D, O = qd_blocks(rng, 2, 7, 3, 2)
    fact = cr_factor(D, O, 3)
    packed = cr_fused.cr_pack(fact)
    assert packed.blocks.shape == (2, 6, 3, 5, 5)
    levels, root, p = cr_fused.cr_unpack(packed)
    assert p == 3 and len(levels) == len(fact[0]) == 3
    for lv_fact, lv_packed in zip(fact[0], levels):
        for u, v in zip(lv_fact, lv_packed):
            assert torch.equal(u, v)
    assert torch.equal(root, fact[1])


def test_kernel_wrapper_checks_its_inputs():
    """The wrapper refuses what the kernel does not take before it builds
    or launches anything."""
    packed, b, _ = packed_case(2, 5, 3, 2, seed=1)
    with pytest.raises(TypeError):
        cr_fused._cr_cuda(packed, b.half())
    with pytest.raises(ValueError, match="shape"):
        cr_fused._cr_cuda(packed, b[:, :4].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        cr_fused._cr_cuda(packed._replace(
            root=packed.root.transpose(1, 2).contiguous().transpose(1, 2)), b)


def test_work_count():
    """The bytes and operations that chip_smoke.py bounds the kernel by,
    at the main path's shapes: one B=64 single-RHS solve, K=30, Wp=48."""
    nbytes, flops = cr_fused.cr_work(64, 30, 48, 4)
    assert nbytes == 50_282_496 and flops == 49_545_216


@pytest.mark.parametrize("K", [8, 30])
def test_kernel_body_skips_the_padding_blocks(host_lib, K):
    """The blocks that cr_work leaves out, the last odd block's Q on each
    level with an even block count (the zero padding of cr_factor), are
    never read: NaN there leaves the kernel body's solution unchanged.
    cr_work counts every other block once."""
    packed, b, _ = packed_case(2, K, 3, 2, seed=K + 7)
    off, pad = 0, []
    for n, o in level_sizes(K):
        if n % 2 == 0:
            pad.append(off + o - 1)
        off += o
    blocks = packed.blocks.clone()
    assert torch.all(blocks[:, pad, 2] == 0)
    blocks[:, pad, 2] = float("nan")
    got = host_solve(host_lib, packed._replace(blocks=blocks), b, 16)
    assert torch.equal(got, host_solve(host_lib, packed, b, 16))
    nbytes, _ = cr_fused.cr_work(1, K, 1, 1)
    assert nbytes == 3 * (K - 1) - len(pad) + 1 + 2 * K


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_on_card(dtype):
    """float64: kernel and plain version agree to 1e-9 relative. float32:
    the kernel, on a float32 factor, lands within F32_CEILING of the
    float64 plain solution."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    packed64, b, (D, O) = packed_case(4, 5, 6, 4, seed=11)
    packed64 = cr_fused.PackedFactor(packed64.blocks.cuda(),
                                     packed64.root.cuda(), packed64.p)
    b = b.cuda()
    ref = cr_solve(cr_fused.cr_unpack(packed64), b)
    if dtype == torch.float32:
        packed = cr_fused.cr_pack(cr_factor(D.float().cuda(),
                                            O.float().cuda(), 6))
    else:
        packed = packed64
    before = kernels.launches["cr_solve"]
    got = cr_fused.cr_solve_single(packed, b.to(dtype))
    torch.cuda.synchronize()
    assert kernels.launches["cr_solve"] == before + 1
    assert torch.isfinite(got).all()
    dist = rel(got, ref)
    print(f"{dtype} kernel distance from the float64 plain solution {dist:.2e}")
    assert dist <= (1e-9 if dtype == torch.float64 else F32_CEILING)
