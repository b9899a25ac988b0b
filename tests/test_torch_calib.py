"""The calibration probes of the port (``scpp_tpu_torch/diag/calib.py``,
``csrc/calib.cu``) against the reference's Pallas probes
(``tools/diag/mono_calib.py``, ``tools/diag/mono_probe.py``).

The reference scripts run their work when imported (``mono_probe.py``
reads ``sys.argv[1]`` at module level), so their bodies are copied here,
with the lines they come from, and run at 2 steps (four of them leave
float32 after 3 to 31 steps from these inputs): through ``pl.pallas_call``
with ``interpret=True`` in the structure of ``run_loop_kernel`` (or of
``mono_probe.bench``), and the bodies with a statically unrolled loop
(the two 48-column sweeps, the 68-plane matvecs E1 and ``matvec``)
eagerly under ``jax.lax.fori_loop``: compiled, each costs seconds.
Inputs: the reference's ``RandomState`` draws, cut to a small batch;
``preferred_element_type`` is the input's dtype, where the reference
names float32, so that the float64 runs stay float64.

E3, E4 and ``matvecdot`` do not trace in JAX as written (a (240,68) added
to a (240,64), and a 68 contracted against a 64): one test shows that,
another that the port's intended matvec is E1's function on the
transposed data. ``csrc/calib_body.cuh`` is compiled with g++ under
``csrc/host_shim.h`` and held against the plain versions, every probe
and, for the register-tiled products, a full 256-thread block and ragged
shapes. The ``cuda``
tests launch ``csrc/calib.cu`` and skip without a GPU; JAX is imported
only by the tests that run the reference, so they also run on a machine
that has only the port's dependencies:
``python -m pytest tests/test_torch_calib.py -m cuda --noconftest -q``.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from scpp_tpu_torch import kernels
from scpp_tpu_torch.diag import calib

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scpp_tpu_torch", "csrc")
STEPS = 2          # every body is finite in float32 for 2 steps
SMALL = 4          # the batch the tests cut the probes to (D2: 128 rows)
# float32 tolerances, relative to 1 + max |reference|: the FMA loops
# (products, matvecs, elementwise) differ in the order of their sums,
# the sweeps also in rsqrt and the cancellation of 48 rank-1 updates
F32_TOL = {"chol_sweep": 1e-4, "chol8flat": 1e-4}
F32_FMA_TOL = 1e-5
F64_TOL = 1e-12


def rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (1.0 + np.abs(ref).max()))


def small_n(name):
    return 128 if name == "D2" else SMALL


# ---------------------------------------------------------------------------
# the reference's bodies, copied
# ---------------------------------------------------------------------------

n, w = SMALL, 48
jax = jnp = pl = None


def import_jax():
    """Bind jax, jax.numpy and Pallas for the copied bodies."""
    global jax, jnp, pl
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl


def run_loop_kernel(body, args, out_shape, iters=STEPS):
    """tools/diag/mono_calib.py:43-66 without the TPU specs and timing,
    in interpret mode."""
    def kern(*refs):
        in_refs, out_ref = refs[:-1], refs[-1]
        in_vals = [r[:] for r in in_refs]

        def step(i, acc):
            return body(acc, i, *in_vals)

        out_ref[:] = jax.lax.fori_loop(
            0, iters, step, jnp.zeros_like(out_ref))

    return pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(out_shape, args[0].dtype),
        interpret=True)(*args)


def eager_loop(body, args, out_shape, iters=STEPS):
    """The same loop outside a kernel, op by op."""
    with jax.disable_jit():
        return jax.lax.fori_loop(
            0, iters, lambda i, acc: body(acc, i, *args),
            jnp.zeros(out_shape, args[0].dtype))


def ew_body(acc, i, a):                      # mono_calib.py:76, 80
    return acc + a * 1.0001 + acc * a


def chol_sweep(acc, i, a):                   # mono_calib.py:85-91
    M = a + acc
    for j in range(w):
        d = jax.lax.rsqrt(jnp.abs(M[:, j, j]) + 1.0)      # (n,)
        c = M[:, :, j] * d[:, None]                        # (n, w)
        M = M - c[:, :, None] * c[:, None, :]
    return M


def chol_sweep_masked(acc, i, a):            # mono_calib.py:96-103
    M = a + acc
    colmask = jax.lax.broadcasted_iota(jnp.int32, (1, w), 1)
    for j in range(w):
        d = jax.lax.rsqrt(jnp.abs(M[:, j, j]) + 1.0)
        c = jnp.where(colmask >= j, M[:, :, j], 0.0) * d[:, None]
        M = M - c[:, :, None] * c[:, None, :]
    return M


def bmm(acc, i, a):                          # mono_calib.py:108-111, 116-119
    return acc + jax.lax.dot_general(
        a, a + acc, (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=a.dtype)


def mm2d(acc, i, a):                         # mono_calib.py:124-126
    return acc + jnp.dot(a + acc, a[:96, :],
                         preferred_element_type=a.dtype)


def fma_mv_3d(acc, i, a, v):                 # mono_calib.py:131-135
    out = acc
    for m in range(68):
        out = out + a[:, m, :] * v[:, m][:, None]
    return out


def mv_reduce(acc, i, a, v):                 # mono_calib.py:140-141
    return acc + jnp.sum(a * v[:, :, None], axis=1)


def mv_dot(acc, i, a, v):                    # mono_calib.py:146-149
    return acc + jax.lax.dot_general(
        a, v + acc, (((1,), (1,)), ((0,), (0,))),
        preferred_element_type=a.dtype)


def mv_t(acc, i, a, v):                      # mono_calib.py:154-157
    return acc + jax.lax.dot_general(
        a, v + acc[:, :64], (((1,), (1,)), ((0,), (0,))),
        preferred_element_type=a.dtype)[:, :68]


def slice_mix(acc, i, a):                    # mono_calib.py:162-164
    x = a[:, 3, :] + a[:, 7, :]
    return acc.at[:, 5, :].set(x) if hasattr(acc, "at") else acc


def probe_kernel(kern, args, out_shape):
    """tools/diag/mono_probe.py:15-33 without the TPU specs and timing,
    in interpret mode."""
    return pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(out_shape, args[0].dtype),
        interpret=True)(*args)


def rank1_kern(a_ref, o_ref):                # mono_probe.py:39-46
    a = a_ref[:]

    def step(i, M):
        c = M[:, :, 0] * 1e-3
        return M - c[:, :, None] * c[:, None, :]
    o_ref[:] = jax.lax.fori_loop(0, STEPS, step, a)


def bdot_kern(a_ref, o_ref):                 # mono_probe.py:51-58, 64-71
    a = a_ref[:]

    def step(i, acc):
        return acc + jax.lax.dot_general(
            a, a + acc * 1e-6, (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=a.dtype)
    o_ref[:] = jax.lax.fori_loop(0, STEPS, step, jnp.zeros_like(a))


def reshape88_kern(a_ref, o_ref):            # mono_probe.py:77-80
    a = a_ref[:]                       # (240, 8, 8)
    flat = a.reshape(n, 64)
    o_ref[:] = (flat + 1.0).reshape(n, 8, 8)


def chol8_mats(dtype):                       # mono_probe.py:93-101
    E_each = np.zeros((8, 64), dtype)
    for i in range(8):
        E_each[i, i * 8:(i + 1) * 8] = 1.0
    E_tile = np.zeros((8, 64), dtype)
    for j in range(8):
        E_tile[j, np.arange(8) * 8 + j] = 1.0
    return jnp.asarray(E_each), jnp.asarray(E_tile)


def chol8flat_kern(a_ref, e1_ref, e2_ref, o_ref):   # mono_probe.py:103-117
    M0 = a_ref[:]
    e_each, e_tile = e1_ref[:], e2_ref[:]

    def step(it, M):
        Mc = M + M0 * 1e-6
        for j in range(8):
            d = jax.lax.rsqrt(jnp.abs(Mc[:, j * 8 + j:j * 8 + j + 1])
                              + 1.0)
            r = Mc[:, j * 8:(j + 1) * 8] * d          # (nb, 8)
            o1 = jnp.dot(r, e_each,
                         preferred_element_type=M0.dtype)
            o2 = jnp.dot(r, e_tile,
                         preferred_element_type=M0.dtype)
            Mc = Mc - o1 * o2
        return Mc
    o_ref[:] = jax.lax.fori_loop(0, STEPS, step, jnp.zeros_like(M0))


def matvec_step(acc, it, a, v):              # mono_probe.py:126-130
    out = acc * 1e-6
    for m in range(68):
        out = out + a[:, m, :] * v[:, m][:, None]
    return out


def matvecdot_kern(a_ref, v_ref, o_ref):     # mono_probe.py:139-148
    a, v = a_ref[:], v_ref[:]

    def step(it, acc):
        return acc * 1e-6 + jax.lax.dot_general(
            a, v + acc[:, :68] * 0.0, (((1,), (1,)), ((0,), (0,))),
            preferred_element_type=a.dtype)
    o_ref[:] = jax.lax.fori_loop(0, STEPS, step,
                                 jnp.zeros((n, 64), a.dtype))


def matvecred_kern(a_ref, v_ref, o_ref):     # mono_probe.py:154-160
    a, v = a_ref[:], v_ref[:]

    def step(it, acc):
        return acc * 1e-6 + jnp.sum(a * v[:, :, None], axis=1)
    o_ref[:] = jax.lax.fori_loop(0, STEPS, step,
                                 jnp.zeros((n, 64), a.dtype))


def transpose_kern(a_ref, o_ref):            # mono_probe.py:167-172
    a = a_ref[:]

    def step(it, acc):
        return acc * 1e-6 + jnp.swapaxes(a + acc * 1e-6, 1, 2)
    o_ref[:] = jax.lax.fori_loop(0, STEPS, step, jnp.zeros_like(a))


# name -> how the reference runs it on (inputs as jnp arrays)
REFERENCE = {
    "A1": lambda a: run_loop_kernel(ew_body, [a], a.shape),
    "A2": lambda a: run_loop_kernel(ew_body, [a], a.shape),
    "B": lambda a: eager_loop(chol_sweep, [a], a.shape),
    "B2": lambda a: eager_loop(chol_sweep_masked, [a], a.shape),
    "C": lambda a: run_loop_kernel(bmm, [a], a.shape),
    "D": lambda a: run_loop_kernel(bmm, [a], a.shape),
    "D2": lambda a: run_loop_kernel(mm2d, [a], a.shape),
    "E1": lambda a, v: eager_loop(fma_mv_3d, [a, v], (n, 64)),
    "E2": lambda a, v: run_loop_kernel(mv_reduce, [a, v], (n, 64)),
    "G": lambda a: run_loop_kernel(slice_mix, [a], a.shape),
    "rank1": lambda a: probe_kernel(rank1_kern, [a], a.shape),
    "bdot": lambda a: probe_kernel(bdot_kern, [a], a.shape),
    "bdot96": lambda a: probe_kernel(bdot_kern, [a], a.shape),
    "reshape88": lambda a: probe_kernel(reshape88_kern, [a], a.shape),
    "chol8flat": lambda a: probe_kernel(
        chol8flat_kern, [a, *chol8_mats(a.dtype)], a.shape),
    "matvec": lambda a, v: eager_loop(matvec_step, [a, v], (n, 64)),
    "matvecred": lambda a, v: probe_kernel(matvecred_kern, [a, v], (n, 64)),
    "transpose": lambda a: probe_kernel(transpose_kern, [a], a.shape),
}
# the bodies with a statically unrolled loop of 48 or 68 slices, which
# run op by op: compiled, each costs seconds
EAGER = ("B", "B2", "E1", "matvec")
# the bodies that do not trace, with their reference runs
UNTRACEABLE = {
    "E3": lambda a, v: run_loop_kernel(mv_dot, [a, v], (n, 64)),
    "E4": lambda a, v: run_loop_kernel(mv_t, [a, v], (n, 68)),
    "matvecdot": lambda a, v: probe_kernel(matvecdot_kern, [a, v], (n, 64)),
}


def port_inputs(name, dtype):
    return calib.probe_inputs(name, "cpu", dtype, n=small_n(name))


@pytest.fixture(scope="module")
def reference_outputs(host_build):
    """Every traceable reference body at 2 steps, in float64 and float32,
    once per module: the interpret-mode kernels of both dtypes in one
    compile, the unrolled bodies (EAGER) op by op."""
    import_jax()
    dtypes = {"f64": torch.float64, "f32": torch.float32}
    ins = {f"{k} {d}": [jnp.asarray(t.numpy())
                        for t in port_inputs(k, dtypes[d])]
           for k in REFERENCE for d in dtypes}
    sweeps = {key for key in ins if key.split()[0] in EAGER}
    jitted = {key: v for key, v in ins.items() if key not in sweeps}
    out = jax.jit(lambda ins: {key: REFERENCE[key.split()[0]](*v)
                               for key, v in ins.items()})(jitted)
    out.update({key: REFERENCE[key.split()[0]](*ins[key]) for key in sweeps})
    return {(key.split()[0], dtypes[key.split()[1]]): np.asarray(v)
            for key, v in out.items()}


@pytest.mark.parametrize("name", sorted(REFERENCE))
def test_plain_probe_matches_reference_body(reference_outputs, name):
    """Float64 to 1e-12; float32 to 1e-5 (1e-4 for the sweeps) relative to
    1 + max |reference|, each against the reference's own dtype."""
    fn = calib.PROBES[name].fn
    for dtype in (torch.float64, torch.float32):
        ref = reference_outputs[name, dtype]
        got = calib.probe(name, STEPS, device="cpu", dtype=dtype,
                          n=small_n(name))
        assert got.dtype == dtype and tuple(got.shape) == ref.shape
        assert np.isfinite(ref).all()
        tol = F64_TOL if dtype == torch.float64 else F32_TOL.get(
            fn, F32_FMA_TOL)
        assert rel(got.numpy(), ref) <= tol, (dtype, rel(got.numpy(), ref))


@pytest.mark.parametrize("name", sorted(UNTRACEABLE))
def test_reference_body_does_not_trace(name):
    """E3, E4 and matvecdot raise TypeError in JAX as written."""
    import_jax()
    ins = [jnp.asarray(t.numpy()) for t in port_inputs(name, torch.float64)]
    with pytest.raises(TypeError):
        UNTRACEABLE[name](*ins)


def test_intended_matvec_is_e1_on_transposed_data(reference_outputs):
    """The port's E3/matvecdot function (summed over the last axis) on
    a^T is E1's function (summed over the middle axis) on a: against the
    reference's E1 body (s = 1) and its ``matvec`` probe (s = 1e-6), in
    float64, to 1e-12."""
    for name, s in (("E1", 1.0), ("matvec", 1e-6)):
        a, v = port_inputs(name, torch.float64)
        got = calib.matvec(a.transpose(1, 2).contiguous(), v, STEPS, s=s,
                           trans=True)
        assert rel(got.numpy(), reference_outputs[name, torch.float64]) \
            <= F64_TOL


def test_probe_table_matches_the_reference_scripts():
    """Names, steps and shapes of the two scripts, and their input draws:
    mono_calib seeds input i with RandomState(i), mono_probe draws every
    input from one RandomState(0)."""
    assert calib.CALIB_NAMES == ("A1", "A2", "B", "B2", "C", "D", "D2",
                                 "E1", "E2", "E3", "E4", "G")
    assert calib.PROBE_NAMES == ("rank1", "bdot", "bdot96", "reshape88",
                                 "chol8flat", "matvec", "matvecdot",
                                 "matvecred", "transpose")
    assert {calib.PROBES[k].iters for k in calib.CALIB_NAMES} == {50}
    assert {k: calib.PROBES[k].iters for k in calib.PROBE_NAMES} == {
        "rank1": 50, "bdot": 50, "bdot96": 50, "reshape88": 0,
        "chol8flat": 20, "matvec": 20, "matvecdot": 20, "matvecred": 20,
        "transpose": 50}
    a, v = calib.probe_inputs("E1", "cpu")
    np.testing.assert_array_equal(
        v.numpy(), np.random.RandomState(1).rand(240, 68).astype(np.float32))
    a, v = calib.probe_inputs("matvec", "cpu")
    rng = np.random.RandomState(0)
    rng.rand(240, 68, 64)
    np.testing.assert_array_equal(v.numpy(),
                                  rng.rand(240, 68).astype(np.float32))
    assert tuple(calib.probe_inputs("D", "cpu")[0].shape) == (120, 96, 96)


def test_work_and_library_yardsticks():
    """The bound counts as the functions are defined (C: 2 w^3 + 2 w^2 per
    matrix and step), a library call for every probe but the sweeps,
    which agrees with the plain version, and the products' per-SM
    floor."""
    ins = calib.probe_inputs("C", "cpu", n=2)
    nbytes, flops = calib.work("C", ins, 3)
    assert nbytes == 2 * 2 * 48 * 48 * 4
    assert flops == 2 * 3 * (2 * 48 ** 3 + 2 * 48 ** 2)
    for name in calib.PROBES:
        ins = calib.probe_inputs(name, "cpu", torch.float64,
                                 n=small_n(name))
        lib, why = calib.library(name, ins, STEPS)
        if calib.PROBES[name].fn in ("chol_sweep", "chol8flat"):
            assert lib is None and "no single PyTorch call" in why
            continue
        got = lib()
        ref = calib._plain_call(name, ins, STEPS)
        assert rel(got.reshape(ref.shape).numpy(), ref.numpy()) <= F64_TOL, \
            name
    # the products' per-SM floor: C's 240 matrices two an SM, D2's 120
    # blocks of 16 rows one an SM, at 128 fp32 FMAs a cycle and 1.98 GHz
    floor = calib.sm_floor_ms
    assert floor("C", calib.probe_inputs("C", "cpu"), 50) == pytest.approx(
        2 * 48 ** 3 * 50 / 128 / 1.98e6)
    assert floor("D2", calib.probe_inputs("D2", "cpu"), 50) == \
        pytest.approx(16 * 96 ** 2 * 50 / 128 / 1.98e6)
    assert floor("A1", calib.probe_inputs("A1", "cpu"), 50) is None


def test_cpu_tensors_take_the_plain_version_and_wrappers_check():
    kernels.reset_launches()
    calib.probe("A1", STEPS, device="cpu", n=2)
    assert not any(kernels.launches[f"calib_{fn}"]
                   for fn in calib.FUNCTIONS)
    a = torch.zeros((2, 48, 48))
    with pytest.raises(TypeError):
        calib._check("bmm", [a.half()], [a.shape])
    with pytest.raises(ValueError, match="shape"):
        calib._check("matvec", [a, torch.zeros(2, 47)], [a.shape, (2, 48)])
    with pytest.raises(ValueError, match="contiguous"):
        calib._check("bmm", [a.transpose(1, 2)], [a.shape])


# ---------------------------------------------------------------------------
# the kernel body, built on the host
# ---------------------------------------------------------------------------

HARNESS = r"""
#include "calib_body.cuh"
#include <thread>
#include <vector>

thread_local Dim3 threadIdx;
Dim3 blockDim;
std::barrier<>* g_barrier;
SpinBarrier** g_warp_barriers;
unsigned long long (*g_warp_xch)[2][32];

// blocks one after another, each with nt std::threads and its own
// shared memory, NaN-filled so that a read before a write shows
template <typename T, typename F>
void blocks(int nb, int nt, long long smem, F f) {
  blockDim.x = nt;
  for (int b = 0; b < nb; ++b) {
    std::vector<T> sm(smem + 1, T(NAN));
    std::barrier<> bar(nt);
    g_barrier = &bar;
    HostWarps warps(nt);
    std::vector<std::thread> th;
    for (int t = 0; t < nt; ++t)
      th.emplace_back([&, t] { threadIdx.x = t; f(b, sm.data()); });
    for (auto& x : th) x.join();
  }
}

#define EXPORT(T, S)                                                          \
extern "C" void ew_##S(long long n, const T* a, T* o, int it) {               \
  for (long long i = 0; i < n; ++i) calib::ew_item<T>(i, a, o, it);          \
}                                                                            \
extern "C" void chol_sweep_##S(int nt, int n, int w, int m, const T* a, T* o,\
                               int it) {                                     \
  blocks<T>(n, nt, w * w + w, [&](int b, T* sm) {                            \
    calib::chol_sweep_block<T>(w, m, a + b * w * w, o + b * w * w, it, sm);  \
  });                                                                        \
}                                                                            \
extern "C" void bmm_##S(int n, int w, double s, const T* a, T* o, int it) { \
  blocks<T>(n, calib::bmm_threads(w), calib::bmm_smem(w), [&](int b, T* sm) {\
    calib::bmm_block<T>(w, T(s), a + b * w * w, o + b * w * w, it, sm);      \
  });                                                                        \
}                                                                            \
extern "C" void mm2d_##S(int rows, int w, const T* a, T* o, int it) {        \
  const int per = calib::kMmRowsPerBlock;                                    \
  blocks<T>((rows + per - 1) / per, calib::kMmThreads, calib::mm2d_smem(w),  \
            [&](int b, T* sm) {                                              \
    calib::mm2d_block<T>(rows, w, b * per, a, o, it, sm);                    \
  });                                                                        \
}                                                                            \
extern "C" void matvec_##S(int nt, int n, int R, int C, int tr, double s,    \
                           const T* a, const T* v, T* o, int it) {           \
  const int O = tr ? R : C, K = tr ? C : R;                                  \
  blocks<T>(n, nt, R * C + K, [&](int b, T* sm) {                            \
    calib::matvec_block<T>(R, C, tr, T(s), a + b * R * C, v + b * K,         \
                           o + b * O, it, sm);                               \
  });                                                                        \
}                                                                            \
extern "C" void rank1_##S(int nt, int n, int w, const T* a, T* o, int it) {  \
  blocks<T>(n, nt, w * w + w, [&](int b, T* sm) {                            \
    calib::rank1_block<T>(w, a + b * w * w, o + b * w * w, it, sm);          \
  });                                                                        \
}                                                                            \
extern "C" void chol8flat_##S(int n, const T* a, T* o, int it) {             \
  for (int r = 0; r < n; ++r) calib::chol8flat_item<T>(r, a, o, it);        \
}                                                                            \
extern "C" void transpose_##S(int nt, int n, int w, const T* a, T* o,        \
                              int it) {                                      \
  blocks<T>(n, nt, 3 * w * w, [&](int b, T* sm) {                            \
    calib::transpose_block<T>(w, a + b * w * w, o + b * w * w, it, sm);      \
  });                                                                        \
}                                                                            \
extern "C" void reshape88_##S(long long n, const T* a, T* o) {               \
  for (long long i = 0; i < n; ++i) calib::reshape88_item<T>(i, a, o);      \
}                                                                            \
extern "C" void slice_mix_##S(int nt, int n, int w, const T* a, T* o,        \
                              int it) {                                      \
  blocks<T>(n, nt, w * w, [&](int b, T* sm) {                                \
    calib::slice_mix_block<T>(w, a + b * w * w, o + b * w * w, it, sm);      \
  });                                                                        \
}

EXPORT(double, f64)
EXPORT(float, f32)

// the products' launch geometry, as csrc/calib.cu takes it
extern "C" int bmm_threads(int w) { return calib::bmm_threads(w); }
extern "C" int bmm_max_width() { return calib::kBmmMaxWidth; }
extern "C" int mm2d_rows_per_block() { return calib::kMmRowsPerBlock; }
extern "C" int mm2d_max_width() { return calib::kMmMaxWidth; }
"""


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """Start g++ on the kernel body; the reference runs meanwhile."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a C++20 compiler is needed to build the kernel body"
    d = tmp_path_factory.mktemp("calib_host")
    (d / "harness.cpp").write_text(HARNESS)
    lib = d / "libcalib_host.so"
    proc = subprocess.Popen(
        [cxx, "-std=c++20", "-O0", "-shared", "-fPIC", "-pthread",
         "-include", os.path.join(CSRC, "host_shim.h"), "-I", CSRC,
         "-o", str(lib), str(d / "harness.cpp")], stderr=subprocess.PIPE)
    yield proc, lib
    proc.kill()


@pytest.fixture(scope="module")
def host_lib(host_build):
    proc, lib = host_build
    _, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err.decode()
    return ctypes.CDLL(str(lib))


NTHREADS = 8       # threads per host block: exercises the strided loops


def host_run(lib, name, ins, iters):
    """The probe through the host-built body, as csrc/calib.cu launches
    it: the products at their own geometry (bmm: one 6 x 6 tile a thread,
    ``bmm_threads(w)`` threads; mm2d: 16 rows and 128 threads a block),
    the other bodies at NTHREADS threads a block."""
    pr = calib.PROBES[name]
    a = np.ascontiguousarray(ins[0].numpy())
    suf = "f64" if a.dtype == np.float64 else "f32"
    ptr = lambda x: ctypes.c_void_p(x.ctypes.data)   # noqa: E731
    I, D, L = ctypes.c_int, ctypes.c_double, ctypes.c_longlong
    fn = getattr(lib, f"{pr.fn}_{suf}")
    kw = pr.kw
    if pr.fn == "matvec":
        v = np.ascontiguousarray(ins[1].numpy())
        nb, R, C = a.shape
        tr = kw.get("trans", False)
        out = np.zeros((nb, R if tr else C), a.dtype)
        fn(I(NTHREADS), I(nb), I(R), I(C), I(tr), D(kw.get("s", 1.0)),
           ptr(a), ptr(v), ptr(out), I(iters))
        return out
    out = np.zeros_like(a)
    if pr.fn in ("ew", "reshape88"):
        args = [L(a.size), ptr(a), ptr(out)]
        fn(*args, *([I(iters)] if pr.fn == "ew" else []))
    elif pr.fn == "chol8flat":
        fn(I(a.shape[0]), ptr(a), ptr(out), I(iters))
    elif pr.fn == "mm2d":
        fn(I(a.shape[0]), I(a.shape[1]), ptr(a), ptr(out), I(iters))
    elif pr.fn == "chol_sweep":
        fn(I(NTHREADS), I(a.shape[0]), I(a.shape[-1]),
           I(kw.get("masked", False)), ptr(a), ptr(out), I(iters))
    elif pr.fn == "bmm":
        fn(I(a.shape[0]), I(a.shape[-1]), D(kw.get("s", 1.0)), ptr(a),
           ptr(out), I(iters))
    else:
        fn(I(NTHREADS), I(a.shape[0]), I(a.shape[-1]), ptr(a), ptr(out),
           I(iters))
    return out


@pytest.mark.parametrize("name", sorted(calib.PROBES))
def test_kernel_body_matches_plain(host_lib, name):
    """The kernel body against the plain version at 2 steps: float64 to
    1e-12, float32 to the tolerances of the reference comparison."""
    fn = calib.PROBES[name].fn
    for dtype in (torch.float64, torch.float32):
        ins = port_inputs(name, dtype)
        ref = calib._plain_call(name, ins, STEPS).numpy()
        got = host_run(host_lib, name, ins, STEPS)
        assert np.isfinite(got).all()
        tol = F64_TOL if dtype == torch.float64 else F32_TOL.get(
            fn, F32_FMA_TOL)
        assert rel(got, ref) <= tol, (dtype, rel(got, ref))


# The register-tiled products beyond the probes' shapes: one block at the
# card's own thread count (bmm: one 96 x 96 matrix, 256 threads; mm2d: 128
# threads), and ragged edges (bmm: w = 40 and 50, not multiples of the
# 6-wide tile, 50 also past 8 x 8 tiles; mm2d: 50 and 97 rows, not
# multiples of the 16 a block, and w = 40, not a multiple of 32). Three
# steps, so that each of the two operand buffers is written twice.
PRODUCT_CASES = {"bmm-96": ("bmm", (1, 96, 96), 1.0),
                 "bmm-40": ("bmm", (3, 40, 40), 1.0),
                 "bmm-50": ("bmm", (2, 50, 50), 1e-6),
                 "mm2d-96": ("mm2d", (97, 96), None),
                 "mm2d-40": ("mm2d", (50, 40), None)}
PRODUCT_STEPS = 3


def product_case(case, dtype, device="cpu"):
    """The case's input (uniform in [0, 1) from RandomState(3)) and its
    plain result."""
    fn, shape, s = PRODUCT_CASES[case]
    a = torch.tensor(np.random.RandomState(3).rand(*shape), dtype=dtype,
                     device=device)
    if fn == "bmm":
        return a, calib._bmm_plain(a, PRODUCT_STEPS, s)
    return a, calib._mm2d_plain(a, PRODUCT_STEPS)


@pytest.mark.parametrize("case", sorted(PRODUCT_CASES))
def test_tiled_product_body_matches_plain(host_lib, case):
    """The host-built bmm and mm2d bodies at their own launch geometry:
    float64 to 1e-12, float32 to 1e-5, relative to 1 + max |plain|."""
    fn, _, s = PRODUCT_CASES[case]
    ptr = lambda x: ctypes.c_void_p(x.ctypes.data)   # noqa: E731
    I = ctypes.c_int
    for dtype, suf, tol in ((torch.float64, "f64", F64_TOL),
                            (torch.float32, "f32", F32_FMA_TOL)):
        a, ref = product_case(case, dtype)
        a = a.numpy()
        out = np.full_like(a, np.nan)
        dims = ([I(a.shape[0]), I(a.shape[-1]), ctypes.c_double(s)]
                if fn == "bmm" else [I(a.shape[0]), I(a.shape[1])])
        getattr(host_lib, f"{fn}_{suf}")(*dims, ptr(a), ptr(out),
                                         I(PRODUCT_STEPS))
        assert np.isfinite(out).all()
        assert rel(out, ref.numpy()) <= tol, (dtype, rel(out, ref.numpy()))


def test_product_geometry_matches_the_wrappers(host_lib):
    """The widths and rows a block that diag/calib.py states are the
    body's, and bmm's launch covers its tiles in whole warps."""
    assert host_lib.bmm_max_width() == calib.PRODUCT_MAX_WIDTH
    assert host_lib.mm2d_max_width() == calib.PRODUCT_MAX_WIDTH
    assert host_lib.mm2d_rows_per_block() == calib.MM2D_ROWS_PER_BLOCK
    assert {w: host_lib.bmm_threads(w) for w in (40, 48, 50, 96)} == {
        40: 64, 48: 64, 50: 96, 96: 256}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(calib.PROBES))
def test_kernel_matches_plain_on_card(name):
    """At the probes' full shapes, 2 steps: float64 to 1e-12 and float32
    to the CPU tolerances, one launch each, counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    fn = calib.PROBES[name].fn
    for dtype in (torch.float64, torch.float32):
        ins = calib.probe_inputs(name, "cuda", dtype)
        before = kernels.launches[f"calib_{fn}"]
        got = calib._call(name, ins, STEPS)
        ref = calib._plain_call(name, ins, STEPS)
        torch.cuda.synchronize()
        assert kernels.launches[f"calib_{fn}"] == before + 1
        tol = F64_TOL if dtype == torch.float64 else F32_TOL.get(
            fn, F32_FMA_TOL)
        assert rel(got.cpu().numpy(), ref.cpu().numpy()) <= tol


@pytest.mark.cuda
def test_tiled_products_on_card():
    """The host cases of the tiled products through their kernels, one
    launch each, at the same tolerances; and w = 97 is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for case, (fn, _, s) in sorted(PRODUCT_CASES.items()):
        for dtype, tol in ((torch.float64, F64_TOL),
                           (torch.float32, F32_FMA_TOL)):
            a, ref = product_case(case, dtype, "cuda")
            before = kernels.launches[f"calib_{fn}"]
            got = (calib.bmm(a, PRODUCT_STEPS, s) if fn == "bmm"
                   else calib.mm2d(a, PRODUCT_STEPS))
            torch.cuda.synchronize()
            assert kernels.launches[f"calib_{fn}"] == before + 1
            assert bool(torch.isfinite(got).all())
            assert rel(got.cpu().numpy(), ref.cpu().numpy()) <= tol, case
    with pytest.raises(ValueError, match="w <= 96"):
        calib.bmm(torch.ones((1, 97, 97), device="cuda"), 1)
    with pytest.raises(ValueError, match="w <= 96"):
        calib.mm2d(torch.ones((97, 97), device="cuda"), 1)


@pytest.mark.cuda
def test_shared_memory_probe_on_card():
    """227 KB of dynamic shared memory is granted to one block, 228 KB is
    refused without a launch, and no error is left behind."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    got = {b: calib.smem_probe(b) for b in calib.SMEM_SIZES}
    assert all(got[b][0] for b in calib.SMEM_SIZES[:3]), got
    assert not got[228 * 1024][0] and got[228 * 1024][1] != 0
    assert got[232448][2] == float(calib.smem_probe_plain(232448))
    calib.bmm(torch.ones((2, 48, 48), device="cuda"), 1)
    torch.cuda.synchronize()
