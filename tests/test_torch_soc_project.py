"""The second-order-cone projection: the plain version against the JAX
package's, and the CUDA kernel's arithmetic against the plain version.

``scpp_tpu_torch/csrc/soc_project_body.cuh`` holds everything the kernel
computes; ``soc_project.cu`` only launches it. On the CPU the header is
compiled with g++ under ``csrc/host_shim.h`` and run item by item, so the
kernel's arithmetic is checked here in float64 and float32; the ``cuda``
test launches the real kernel and skips without a GPU. Only
``test_plain_matches_reference`` imports JAX (inside the test), so the
rest runs on the card without it:
``python -m pytest tests/test_torch_soc_project.py -m cuda --noconftest``.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from scpp_tpu_torch import kernels
from scpp_tpu_torch.ops import soc_project as sp

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scpp_tpu_torch", "csrc")

HARNESS = r"""
#include "soc_project_body.cuh"

template <typename T>
int run(int B, int n_cones, long long ld, const int* head, const int* size,
        T* w) {
  for (long long i = 0; i < (long long)B * n_cones; ++i)
    soc::project_item<T>(i, n_cones, ld, head, size, w);
  return 0;
}

extern "C" int host_soc(int B, int n_cones, long long ld, const int* head,
                        const int* size, double* w) {
  return run<double>(B, n_cones, ld, head, size, w);
}
extern "C" int host_soc_f32(int B, int n_cones, long long ld,
                            const int* head, const int* size, float* w) {
  return run<float>(B, n_cones, ld, head, size, w);
}
"""

# The float32 kernel body must land within this of the float64 plain
# projection (max |error| relative to 1 + max |plain|), about four times
# reading here (test_kernel_body_float32_near_float64: 3.63e-8 for the
# kernel body and for the plain version in float32; they print under -s).
F32_CEILING = 1.5e-7


def cone_blocks(rng, q, G=3):
    """G blocks of size q, a third strictly inside the cone, a third
    strictly inside its polar (below), a third outside both; then z = 0
    with t > 0, t < 0 and t = 0, and a block on the boundary."""
    z = rng.standard_normal((G, q - 1)) * rng.uniform(0.1, 10.0, (G, 1))
    zn = np.linalg.norm(z, axis=1)
    k = G // 3
    t = np.concatenate([zn[:k] * rng.uniform(1.1, 3.0, k),
                        -zn[k:2 * k] * rng.uniform(1.1, 3.0, k),
                        zn[2 * k:] * rng.uniform(-0.9, 0.9, G - 2 * k)])
    blocks = np.concatenate([t[:, None], z], axis=1)
    zero = np.zeros((4, q))
    zero[:, 0] = [1.5, -2.0, 0.0, 0.0]
    if q > 1:
        zero[3, 1:] = rng.standard_normal(q - 1)
        zero[3, 0] = np.linalg.norm(zero[3, 1:])
    return np.concatenate([blocks, zero])


def layout_case(rng, B, sizes, offset, ld_extra):
    """A (B, m + ld_extra) tensor whose first m columns hold ``offset``
    free rows and then one block of each size per scenario, cone c of
    scenario b in case (b + c) % 7 of ``cone_blocks``, with the SocBlocks
    of those columns; the extra columns check the row stride."""
    blocks = sp.soc_blocks(offset, tuple(sizes))
    m = offset + sum(sizes)
    w = rng.standard_normal((B, m + ld_extra)) * 3.0
    for b in range(B):
        for c, (h, q) in enumerate(zip(blocks.heads, blocks.sizes)):
            w[b, h:h + q] = cone_blocks(rng, q)[(b + c) % 7]
    return torch.tensor(w), blocks, m


def plain(w, blocks, m):
    out = w.clone()
    sp._soc_plain(out[:, :m], blocks)
    return out


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a C++20 compiler is needed to build the kernel body"
    d = tmp_path_factory.mktemp("soc_host")
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libsoc_host.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-include", os.path.join(CSRC, "host_shim.h"), "-I",
                    CSRC, "-o", str(lib), str(d / "harness.cpp")],
                   check=True, capture_output=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    for fn, c_t in ((so.host_soc, ctypes.c_double),
                    (so.host_soc_f32, ctypes.c_float)):
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int), ctypes.POINTER(c_t)]
    return so


def host_project(lib, w, blocks):
    """The kernel body over every (scenario, cone) of w, in a copy."""
    f32 = w.dtype == torch.float32
    arr = np.ascontiguousarray(w.numpy()).copy()
    heads = np.asarray(blocks.heads, dtype=np.int32)
    sizes = np.asarray(blocks.sizes, dtype=np.int32)
    IP = ctypes.POINTER(ctypes.c_int)
    P = ctypes.POINTER(ctypes.c_float if f32 else ctypes.c_double)
    (lib.host_soc_f32 if f32 else lib.host_soc)(
        arr.shape[0], len(blocks), arr.shape[1], heads.ctypes.data_as(IP),
        sizes.ctypes.data_as(IP), arr.ctypes.data_as(P))
    return torch.from_numpy(arr)


def rel(a, b):
    return float((a.double() - b).abs().max() / (1 + b.abs().max()))


# the MPC's cones (7, 13 and seven of 2) and sizes 1-40
SIZES = (7, 13) + (2,) * 7 + tuple(range(1, 41))


@pytest.mark.parametrize("q", [2, 7, 13, 37])
def test_plain_matches_reference(q):
    """The plain version against the reference's Pallas kernel in
    interpret mode and its jnp reference, at 1e-15: all three cases and
    z = 0."""
    import jax
    import jax.numpy as jnp
    from scpp_tpu.ops import soc_pallas

    x = cone_blocks(np.random.default_rng(q), q, 30)
    got = sp.soc_project_blocks_reference(torch.tensor(x))
    # the jnp reference jitted: one compile instead of one per primitive
    j_ref = jax.jit(soc_pallas.soc_project_blocks_reference)
    for ref in (soc_pallas.soc_project_blocks(jnp.asarray(x), q, True),
                j_ref(jnp.asarray(x))):
        ref = torch.tensor(np.asarray(ref))
        assert ref.dtype == torch.float64
        assert rel(got, ref) <= 1e-15


def test_kernel_body_matches_plain(host_lib):
    """Float64 agreement to 1e-14 relative on every case, at the MPC's
    sizes and 1-40, with a row stride wider than the cone vector."""
    w, blocks, m = layout_case(np.random.default_rng(0), 5, SIZES, 9, 3)
    ref = plain(w, blocks, m)
    got = host_project(host_lib, w, blocks)
    assert torch.equal(got[:, :9], w[:, :9])
    assert torch.equal(got[:, m:], w[:, m:])
    assert rel(got, ref) <= 1e-14


def test_kernel_body_float32_near_float64(host_lib):
    w, blocks, m = layout_case(np.random.default_rng(1), 5, SIZES, 4, 0)
    ref = plain(w, blocks, m)
    got = host_project(host_lib, w.float(), blocks)
    plain32 = plain(w.float(), blocks, m)
    print(f"float32 distance from the float64 plain projection: kernel "
          f"body {rel(got, ref):.2e}, plain version {rel(plain32, ref):.2e}")
    assert rel(got, ref) <= F32_CEILING


def test_cpu_tensors_take_the_plain_version():
    kernels.reset_launches()
    w, blocks, m = layout_case(np.random.default_rng(2), 3, SIZES, 2, 2)
    got = w.clone()
    sp.soc_project_(got[:, :m], blocks)
    assert torch.equal(got, plain(w, blocks, m))
    assert kernels.launches["soc_project"] == 0


def test_kernel_wrapper_checks_its_inputs():
    """The wrapper refuses what the kernel does not take before it builds
    or launches anything."""
    w, blocks, m = layout_case(np.random.default_rng(3), 2, (3, 4), 1, 0)
    with pytest.raises(TypeError):
        sp._soc_cuda(w.half(), blocks)
    with pytest.raises(ValueError, match="stride"):
        sp._soc_cuda(w.t().contiguous().t(), blocks)
    with pytest.raises(ValueError, match="columns"):
        sp._soc_cuda(w[:, :m - 1], blocks)


def test_layout_and_work_count():
    """The table of the MPC's cones (after its 42 + 52 rows) and the bytes
    and operations chip_smoke.py bounds the kernel by, counted on the
    data: each SOC value read once, the blocks outside their cone written
    once; 2 q - 1 operations a block, q + 4 more outside."""
    mpc = (7, 13) + (2,) * 7
    blocks = sp.soc_blocks(94, mpc)
    assert blocks is sp.soc_blocks(94, mpc)
    assert blocks.heads == (94, 101, 114, 116, 118, 120, 122, 124, 126)
    assert blocks.table("cpu").tolist() == [list(blocks.heads), list(mpc)]
    assert sorted(blocks.groups) == [2, 7, 13]
    # scenario 0: every block strictly inside; scenario 1: every block
    # outside; scenario 2: the 7-block below its polar, the rest inside
    w = torch.zeros((3, 128), dtype=torch.float32)
    for h, q in zip(blocks.heads, mpc):
        w[:, h + 1:h + q] = 1.0
        w[:, h] = torch.tensor([q + 1.0, 0.0, q + 1.0])
    w[2, 94] = -10.0
    nbytes, flops = sp.soc_work(w, blocks)
    outside = 34 + 7
    assert nbytes == 4 * (3 * 34 + outside)
    assert flops == 3 * (2 * 34 - 9) + (34 + 4 * 9) + (7 + 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_plain_on_card(dtype):
    """float64: kernel and plain version agree to 1e-12 relative;
    float32: the kernel lands within F32_CEILING of the float64 plain
    projection. One launch per call, on a column slice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    w, blocks, m = layout_case(np.random.default_rng(4), 64, SIZES, 94, 5)
    ref = plain(w, blocks, m)
    got = w.to(dtype).cuda()
    before = kernels.launches["soc_project"]
    sp.soc_project_(got[:, :m], blocks)
    torch.cuda.synchronize()
    assert kernels.launches["soc_project"] == before + 1
    got = got.cpu()
    assert torch.equal(got[:, m:], w[:, m:].to(dtype))
    dist = rel(got, ref)
    print(f"{dtype} kernel distance from the float64 plain projection "
          f"{dist:.2e}")
    assert dist <= (1e-12 if dtype == torch.float64 else F32_CEILING)
