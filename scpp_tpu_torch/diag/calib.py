"""The calibration probes: hand-written CUDA kernels, their plain
versions and the probe table (counterpart of the Pallas probes in
``tools/diag/mono_calib.py`` and ``tools/diag/mono_probe.py``).

Each probe runs a function ``iters`` times with a data dependency inside
one launch of a kernel of ``csrc/calib.cu`` (one ``__global__`` per
function; the arithmetic is ``csrc/calib_body.cuh``). The functions, with
``acc`` starting at zero unless said otherwise:

- ``ew``: ``acc + a * 1.0001 + acc * a`` (A1, A2);
- ``chol_sweep``: M = a + acc, then for each column j,
  ``d = rsqrt(|M_jj| + 1)``, ``c = M[:, j] * d`` and ``M -= c c^T``; with
  ``masked`` the rows of c above j are zero (B, B2);
- ``bmm``: ``acc + a @ (a + s * acc)`` (C, D with s = 1; bdot, bdot96
  with s = 1e-6);
- ``mm2d``: ``acc + (a + acc) @ a[:w]`` on (rows, w) (D2);
- ``matvec``: ``acc * s + sum_m a[:, m, :] v[:, m]``, or with ``trans``
  ``acc * s + sum_m a[:, :, m] v[:, m]`` (E1-E4, matvec, matvecdot,
  matvecred: the reference's E3, E4 and matvecdot do not trace, so they
  are ported as what their names and docstring say);
- ``rank1``: ``M - c c^T`` with ``c = M[:, :, 0] * 1e-3``, from M = a;
- ``chol8flat``: on (n, 64) rows, ``Mc = M + M0 * 1e-6``, then for each
  j < 8, ``d = rsqrt(|Mc[8j + j]| + 1)``, ``r = Mc[8j:8j + 8] * d`` and
  ``Mc[8i + k] -= r_i r_k``;
- ``transpose``: ``acc * 1e-6 + (a + acc * 1e-6)^T``;
- ``reshape88``: ``a + 1`` (one pass, no loop);
- ``slice_mix``: row 5 of acc := ``a[:, 3, :] + a[:, 7, :]`` (G).

``smem_probe`` asks for a size of dynamic shared memory, the counterpart
of the VMEM probe F. On a CUDA tensor each function launches its kernel
(counted in ``kernels.launches["calib_<function>"]``) or raises; on a CPU
tensor it runs the plain version. Nothing falls back.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from scpp_tpu_torch import kernels

__all__ = ["FUNCTIONS", "PROBES", "CALIB_NAMES", "PROBE_NAMES",
           "ew", "chol_sweep", "bmm", "mm2d", "matvec", "rank1",
           "chol8flat", "transpose", "reshape88", "slice_mix",
           "smem_probe", "smem_probe_plain", "SMEM_SIZES", "probe_inputs",
           "probe", "plain", "work", "library", "measure", "sm_floor_ms",
           "card"]

FUNCTIONS = kernels.CALIB_FUNCTIONS

# the TPU kernel each function replaces: the Pallas loop-kernel wrapper
# of mono_calib.py, its VMEM probe, or mono_probe.py's bench
REPLACES = {"smem_probe": "tools/diag/mono_calib.py:180",
            "rank1": "tools/diag/mono_probe.py:15",
            "chol8flat": "tools/diag/mono_probe.py:15",
            "transpose": "tools/diag/mono_probe.py:15",
            "reshape88": "tools/diag/mono_probe.py:15"}
for _f in FUNCTIONS:
    REPLACES.setdefault(_f, "tools/diag/mono_calib.py:43")

# The products' geometry (csrc/calib_body.cuh, which the host tests read
# back): bmm and mm2d take w <= 96; mm2d runs 16 rows a block.
PRODUCT_MAX_WIDTH = 96
MM2D_ROWS_PER_BLOCK = 16

# The shared-memory sizes the probe asks for: 48 KB (the static limit),
# 96 KB, the 227 KB a block may opt into on Hopper, and one KB more.
SMEM_SIZES = (48 * 1024, 96 * 1024, 232448, 228 * 1024)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _ew_plain(a, iters):
    acc = torch.zeros_like(a)
    for _ in range(iters):
        acc = acc + a * 1.0001 + acc * a
    return acc


def _chol_sweep_plain(a, iters, masked=False):
    w = a.shape[-1]
    rows = torch.arange(w, device=a.device)
    acc = torch.zeros_like(a)
    for _ in range(iters):
        M = a + acc
        for j in range(w):
            d = torch.rsqrt(M[:, j, j].abs() + 1.0)
            c = M[:, :, j]
            if masked:
                c = torch.where(rows >= j, c, torch.zeros_like(c))
            c = c * d[:, None]
            M = M - c[:, :, None] * c[:, None, :]
        acc = M
    return acc


def _bmm_plain(a, iters, s=1.0):
    acc = torch.zeros_like(a)
    for _ in range(iters):
        acc = acc + a @ (a + acc * s)
    return acc


def _mm2d_plain(a, iters):
    w = a.shape[1]
    acc = torch.zeros_like(a)
    for _ in range(iters):
        acc = acc + (a + acc) @ a[:w]
    return acc


def _matvec_plain(a, v, iters, s=1.0, trans=False):
    n, R, C = a.shape
    acc = a.new_zeros((n, R if trans else C))
    for _ in range(iters):
        mv = ((a * v[:, None, :]).sum(2) if trans
              else (a * v[:, :, None]).sum(1))
        acc = acc * s + mv
    return acc


def _rank1_plain(a, iters):
    M = a
    for _ in range(iters):
        c = M[:, :, 0] * 1e-3
        M = M - c[:, :, None] * c[:, None, :]
    return M


def _chol8flat_plain(M0, iters):
    n = M0.shape[0]
    M = torch.zeros_like(M0)
    for _ in range(iters):
        Mc = M + M0 * 1e-6
        for j in range(8):
            d = torch.rsqrt(Mc[:, 9 * j].abs() + 1.0)
            r = Mc[:, 8 * j:8 * j + 8] * d[:, None]
            Mc = Mc - (r[:, :, None] * r[:, None, :]).reshape(n, 64)
        M = Mc
    return M


def _transpose_plain(a, iters):
    acc = torch.zeros_like(a)
    for _ in range(iters):
        acc = acc * 1e-6 + (a + acc * 1e-6).transpose(1, 2)
    return acc


def _reshape88_plain(a):
    n = a.shape[0]
    return (a.reshape(n, 64) + 1.0).reshape(a.shape)


def _slice_mix_plain(a, iters):
    acc = torch.zeros_like(a)
    for _ in range(iters):
        acc = acc.clone()
        acc[:, 5, :] = a[:, 3, :] + a[:, 7, :]
    return acc


plain = {"ew": _ew_plain, "chol_sweep": _chol_sweep_plain,
         "bmm": _bmm_plain, "mm2d": _mm2d_plain, "matvec": _matvec_plain,
         "rank1": _rank1_plain, "chol8flat": _chol8flat_plain,
         "transpose": _transpose_plain, "reshape88": _reshape88_plain,
         "slice_mix": _slice_mix_plain}


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

_ARGS = {  # C arguments after (elem_bytes, stream), as ctypes types
    "ew": "L P P i", "chol_sweep": "i i i P P i", "bmm": "i i d P P i",
    "mm2d": "i i P P i", "matvec": "i i i i d P P P i",
    "rank1": "i i P P i", "chol8flat": "i P P i", "transpose": "i i P P i",
    "reshape88": "L P P", "slice_mix": "i i P P i"}
_CT = {"L": ctypes.c_longlong, "P": ctypes.c_void_p, "i": ctypes.c_int,
       "d": ctypes.c_double}


def _load_lib():
    lib = kernels.load("calib")
    if lib.calib_ew.argtypes is None:
        for name, sig in _ARGS.items():
            fn = getattr(lib, f"calib_{name}")
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p] + [
                _CT[c] for c in sig.split()]
            fn.restype = ctypes.c_int
        lib.calib_smem_probe.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                         ctypes.c_void_p]
        lib.calib_smem_probe.restype = ctypes.c_int
    return lib


def _check(name, tensors, shapes):
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32 or float64, not {dtype}")
    for t, shp in zip(tensors, shapes):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{dtype} on {dev}")
        if tuple(t.shape) != tuple(shp):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shp)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _launch(name, inputs, out_shape, dims, iters=None):
    """Allocate the output and launch ``calib_<name>(dims..., inputs...,
    out[, iters])`` on the current stream, and count it."""
    t0 = inputs[0]
    out = torch.empty(out_shape, dtype=t0.dtype, device=t0.device)
    lib = _load_lib()
    args = [*dims, *(t.data_ptr() for t in inputs), out.data_ptr()]
    if iters is not None:
        args.append(iters)
    with torch.cuda.device(t0.device):
        stream = torch.cuda.current_stream(t0.device).cuda_stream
        err = getattr(lib, f"calib_{name}")(t0.element_size(), stream, *args)
    if err != 0:
        raise RuntimeError(f"calib {name} kernel launch failed: CUDA error "
                           f"{err}")
    kernels.launches[f"calib_{name}"] += 1
    return out


def ew(a, iters):
    """``acc + a * 1.0001 + acc * a``, ``iters`` times, on any shape."""
    if not a.is_cuda:
        return _ew_plain(a, iters)
    _check("ew", [a], [a.shape])
    return _launch("ew", [a], a.shape, [a.numel()], iters)


def chol_sweep(a, iters, masked=False):
    """The 48-column sweep of probe B (B2 with ``masked``) on (n, w, w)."""
    if not a.is_cuda:
        return _chol_sweep_plain(a, iters, masked)
    n, w = a.shape[0], a.shape[-1]
    _check("chol_sweep", [a], [(n, w, w)])
    return _launch("chol_sweep", [a], a.shape, [n, w, int(masked)], iters)


def bmm(a, iters, s=1.0):
    """``acc + a @ (a + s * acc)`` on (n, w, w); the kernel takes
    w <= 96."""
    if not a.is_cuda:
        return _bmm_plain(a, iters, s)
    n, w = a.shape[0], a.shape[-1]
    _check("bmm", [a], [(n, w, w)])
    if w > PRODUCT_MAX_WIDTH:
        raise ValueError(f"bmm: w = {w}, the kernel takes w <= "
                         f"{PRODUCT_MAX_WIDTH}")
    return _launch("bmm", [a], a.shape, [n, w, float(s)], iters)


def mm2d(a, iters):
    """``acc + (a + acc) @ a[:w]`` on (rows, w), rows >= w; the kernel
    takes w <= 96."""
    if not a.is_cuda:
        return _mm2d_plain(a, iters)
    rows, w = a.shape
    if rows < w:
        raise ValueError(f"mm2d: {rows} rows, fewer than the {w} columns")
    _check("mm2d", [a], [(rows, w)])
    if w > PRODUCT_MAX_WIDTH:
        raise ValueError(f"mm2d: w = {w}, the kernel takes w <= "
                         f"{PRODUCT_MAX_WIDTH}")
    return _launch("mm2d", [a], a.shape, [rows, w], iters)


def matvec(a, v, iters, s=1.0, trans=False):
    """``acc * s + A v`` with a (n, R, C): summed over R with v (n, R)
    into (n, C), or with ``trans`` over C with v (n, C) into (n, R)."""
    if not a.is_cuda:
        return _matvec_plain(a, v, iters, s, trans)
    n, R, C = a.shape
    _check("matvec", [a, v], [(n, R, C), (n, C if trans else R)])
    return _launch("matvec", [a, v], (n, R if trans else C),
                   [n, R, C, int(trans), float(s)], iters)


def rank1(a, iters):
    """``M - c c^T``, ``c = M[:, :, 0] * 1e-3``, from M = a (n, w, w)."""
    if not a.is_cuda:
        return _rank1_plain(a, iters)
    n, w = a.shape[0], a.shape[-1]
    _check("rank1", [a], [(n, w, w)])
    return _launch("rank1", [a], a.shape, [n, w], iters)


def chol8flat(M0, iters):
    """The lane-flat 8x8 sweep of mono_probe's chol8flat on (n, 64)."""
    if not M0.is_cuda:
        return _chol8flat_plain(M0, iters)
    n = M0.shape[0]
    _check("chol8flat", [M0], [(n, 64)])
    return _launch("chol8flat", [M0], M0.shape, [n], iters)


def transpose(a, iters):
    """``acc * 1e-6 + (a + acc * 1e-6)^T`` on (n, w, w)."""
    if not a.is_cuda:
        return _transpose_plain(a, iters)
    n, w = a.shape[0], a.shape[-1]
    _check("transpose", [a], [(n, w, w)])
    return _launch("transpose", [a], a.shape, [n, w], iters)


def reshape88(a):
    """``a + 1`` on (n, 8, 8), read as (n, 64)."""
    if not a.is_cuda:
        return _reshape88_plain(a)
    _check("reshape88", [a], [(a.shape[0], 8, 8)])
    return _launch("reshape88", [a], a.shape, [a.numel()])


def slice_mix(a, iters):
    """Zeros but row 5 := ``a[:, 3, :] + a[:, 7, :]``, on (n, w, w)."""
    if not a.is_cuda:
        return _slice_mix_plain(a, iters)
    n, w = a.shape[0], a.shape[-1]
    if w < 8:
        raise ValueError("slice_mix reads row 7: w must be at least 8")
    _check("slice_mix", [a], [(n, w, w)])
    return _launch("slice_mix", [a], a.shape, [n, w], iters)


def smem_probe(nbytes, device="cuda", check=True):
    """Ask for ``nbytes`` of dynamic shared memory in one block, touch its
    first and last word. Returns (ok, CUDA error code, the kernel's sum of
    the two words): a size the card refuses is reported, not raised, and
    its kernel never launches (sum None). With ``check`` the sum is read
    back (a synchronisation) and ok says it is 3; without, ok says that
    the launch was taken."""
    lib = _load_lib()
    out = torch.zeros(1, dtype=torch.float32, device=device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.calib_smem_probe(stream, int(nbytes), out.data_ptr())
    if err != 0:
        return False, err, None
    kernels.launches["calib_smem_probe"] += 1
    if not check:
        return True, 0, out
    value = float(out)
    return value == 3.0, 0, value


def smem_probe_plain(nbytes, device="cuda"):
    """The probe's function on a buffer in device memory: write the first
    and last word of ``nbytes``, return their sum."""
    buf = torch.empty(int(nbytes) // 4, dtype=torch.float32, device=device)
    buf[0] = 1.0
    buf[-1] = 2.0
    return buf[0] + buf[-1]


_FN = {"ew": ew, "chol_sweep": chol_sweep, "bmm": bmm, "mm2d": mm2d,
       "matvec": matvec, "rank1": rank1, "chol8flat": chol8flat,
       "transpose": transpose, "reshape88": reshape88,
       "slice_mix": slice_mix}


# ---------------------------------------------------------------------------
# the probe table
# ---------------------------------------------------------------------------

N, W = 240, 48   # the probes' batch and block width


@dataclass(frozen=True)
class Probe:
    label: str          # the reference's printed name
    fn: str             # the function of FUNCTIONS it runs
    shapes: Tuple       # input shapes
    iters: int          # dependent steps in one launch (0: no loop)
    body: str           # the reference body it ports, file:lines
    kw: Dict = field(default_factory=dict)
    shared_rng: bool = False   # mono_probe's one RandomState(0) stream


PROBES: Dict[str, Probe] = {
    "A1": Probe("A1 elementwise 3D (240,48,48)", "ew", ((N, W, W),), 50,
                "tools/diag/mono_calib.py:74-77"),
    "A2": Probe("A2 elementwise 2D (11520,48)", "ew", ((N * W, W),), 50,
                "tools/diag/mono_calib.py:78-81"),
    "B": Probe("B  48-col chol-style sweep 3D", "chol_sweep", ((N, W, W),),
               50, "tools/diag/mono_calib.py:85-93"),
    "B2": Probe("B2 48-col chol sweep 3D masked", "chol_sweep",
                ((N, W, W),), 50, "tools/diag/mono_calib.py:96-105",
                {"masked": True}),
    "C": Probe("C  batched mm (240,48,48)^2", "bmm", ((N, W, W),), 50,
               "tools/diag/mono_calib.py:108-113"),
    "D": Probe("D  batched mm (120,96,96)^2", "bmm",
               ((N // 2, 2 * W, 2 * W),), 50,
               "tools/diag/mono_calib.py:116-121"),
    "D2": Probe("D2 2D mm (1920,96)@(96,96)", "mm2d", ((1920, 96),), 50,
                "tools/diag/mono_calib.py:124-128"),
    "E1": Probe("E1 matvec FMA 3D-slice (240,68,64)", "matvec",
                ((N, 68, 64), (N, 68)), 50,
                "tools/diag/mono_calib.py:131-137"),
    "E2": Probe("E2 matvec bcast-reduce mid-axis", "matvec",
                ((N, 68, 64), (N, 68)), 50,
                "tools/diag/mono_calib.py:140-143"),
    "E3": Probe("E3 matvec batched dot (240,64,68)@(68)", "matvec",
                ((N, 64, 68), (N, 68)), 50,
                "tools/diag/mono_calib.py:146-151", {"trans": True}),
    "E4": Probe("E4 matvec batched dot (240,68,64)@(64)", "matvec",
                ((N, 68, 64), (N, 64)), 50,
                "tools/diag/mono_calib.py:154-159", {"trans": True}),
    "G": Probe("G  3D mid-index read+set", "slice_mix", ((N, W, W),), 50,
               "tools/diag/mono_calib.py:162-170"),
    "rank1": Probe("rank1 3D outer (240,48,48), 50 steps", "rank1",
                   ((N, W, W),), 50, "tools/diag/mono_probe.py:37-49",
                   shared_rng=True),
    "bdot": Probe("batched dot (240,48,48)^2, 50 steps", "bmm",
                  ((N, W, W),), 50, "tools/diag/mono_probe.py:50-62",
                  {"s": 1e-6}, True),
    "bdot96": Probe("batched dot (120,96,96)^2, 50 steps", "bmm",
                    ((N // 2, 96, 96),), 50,
                    "tools/diag/mono_probe.py:63-75", {"s": 1e-6}, True),
    "reshape88": Probe("reshape (240,8,8)<->(240,64)", "reshape88",
                       ((N, 8, 8),), 0, "tools/diag/mono_probe.py:76-84",
                       shared_rng=True),
    "chol8flat": Probe("chol8 lane-flat (240,64), 20x8 cols", "chol8flat",
                       ((N, 64),), 20, "tools/diag/mono_probe.py:85-121",
                       shared_rng=True),
    "matvec": Probe("matvec FMA 3D static (240,68,64), 20x", "matvec",
                    ((N, 68, 64), (N, 68)), 20,
                    "tools/diag/mono_probe.py:122-137", {"s": 1e-6}, True),
    "matvecdot": Probe("matvec batched-dot (240,64,68)@(240,68), 20x",
                       "matvec", ((N, 64, 68), (N, 68)), 20,
                       "tools/diag/mono_probe.py:138-152",
                       {"s": 1e-6, "trans": True}, True),
    "matvecred": Probe("matvec bcast+mid-reduce (240,68,64), 20x", "matvec",
                       ((N, 68, 64), (N, 68)), 20,
                       "tools/diag/mono_probe.py:153-165", {"s": 1e-6},
                       True),
    "transpose": Probe("batched transpose (240,48,48), 50x", "transpose",
                       ((N, W, W),), 50, "tools/diag/mono_probe.py:166-175",
                       shared_rng=True),
}
# the probes of mono_calib.py and those of mono_probe.py, in their order
CALIB_NAMES = tuple(k for k, p in PROBES.items() if not p.shared_rng)
PROBE_NAMES = tuple(k for k, p in PROBES.items() if p.shared_rng)


def probe_inputs(name, device="cuda", dtype=torch.float32, n=None):
    """The probe's inputs as the reference draws them: mono_calib seeds
    ``RandomState(i)`` for input i, mono_probe draws every input from one
    ``RandomState(0)``. ``n`` cuts the batch (the leading axis; for D2
    the rows, at least 96) for tests at a small size."""
    pr = PROBES[name]
    rng = np.random.RandomState(0)
    out = []
    for i, shp in enumerate(pr.shapes):
        if not pr.shared_rng:
            rng = np.random.RandomState(i)
        x = rng.rand(*shp).astype(np.float32)
        if n is not None:
            x = x[:n]
        out.append(torch.tensor(x, dtype=dtype, device=device))
    return out


def _call(name, ins, iters, fns=None):
    """Probe ``name``'s function on ``ins`` through the wrappers, or
    through ``fns`` (``plain``)."""
    pr = PROBES[name]
    fn = (fns or _FN)[pr.fn]
    return fn(*ins) if pr.fn == "reshape88" else fn(*ins, iters, **pr.kw)


def _plain_call(name, ins, iters):
    return _call(name, ins, iters, plain)


def probe(name, iters=None, device="cuda", dtype=torch.float32, n=None):
    """Run probe ``name`` on its inputs (``probe_inputs``): the card's
    kernel on a CUDA device, the plain version on the CPU."""
    pr = PROBES[name]
    return _call(name, probe_inputs(name, device, dtype, n),
                 pr.iters if iters is None else iters)


# ---------------------------------------------------------------------------
# work, library yardsticks, timing
# ---------------------------------------------------------------------------


def work(name, ins, iters):
    """Bytes the function must move (each input read once, the output
    written once) and its floating-point operations, ``iters`` dependent
    steps, counted as the function is defined on these shapes."""
    pr = PROBES[name]
    e = ins[0].element_size()
    a = ins[0]
    if pr.fn == "ew":
        return 2 * a.numel() * e, 4 * a.numel() * iters
    if pr.fn in ("chol_sweep", "rank1", "transpose", "bmm"):
        n, w = a.shape[0], a.shape[-1]
        nbytes = 2 * n * w * w * e
        if pr.fn == "chol_sweep":
            if pr.kw.get("masked"):
                cols = sum(3 + (w - j) + 2 * (w - j) ** 2 for j in range(w))
            else:
                cols = w * (3 + w + 2 * w * w)
            return nbytes, n * iters * (w * w + cols)
        if pr.fn == "rank1":
            return nbytes, n * iters * (w + 2 * w * w)
        if pr.fn == "transpose":
            return nbytes, n * iters * 4 * w * w
        s = pr.kw.get("s", 1.0)
        return nbytes, n * iters * ((2 if s == 1.0 else 3) * w * w
                                    + 2 * w ** 3)
    if pr.fn == "mm2d":
        rows, w = a.shape
        return 2 * rows * w * e, iters * (2 * rows * w + 2 * rows * w * w)
    if pr.fn == "matvec":
        n, R, C = a.shape
        trans = pr.kw.get("trans", False)
        O = R if trans else C
        scale = 0 if pr.kw.get("s", 1.0) == 1.0 else O
        nbytes = (a.numel() + ins[1].numel() + n * O) * e
        return nbytes, n * iters * (2 * R * C + scale)
    if pr.fn == "chol8flat":
        n = a.shape[0]
        return 2 * n * 64 * e, n * iters * (128 + 8 * (3 + 8 + 2 * 64))
    if pr.fn == "reshape88":
        return 2 * a.numel() * e, a.numel()
    if pr.fn == "slice_mix":
        n, w = a.shape[0], a.shape[-1]
        # rows 3 and 7 read, the whole output written, row 5's sums once
        return (2 * n * w + n * w * w) * e, n * w
    raise KeyError(name)


NO_LIBRARY = {
    "chol_sweep": "no single PyTorch call runs this rank-1 sweep (an "
                  "unpivoted update with rsqrt(|pivot| + 1) scaling over "
                  "the whole block)",
    "chol8flat": "no single PyTorch call runs this lane-flat 8x8 sweep",
}


def library(name, ins, iters) -> Tuple[Optional[Callable], str]:
    """One PyTorch call per step that computes the step's function (TF32
    off), looped over the same ``iters`` dependent steps: (callable,
    description), or (None, the reason) where no single call exists."""
    pr = PROBES[name]
    kw = pr.kw
    if pr.fn in NO_LIBRARY:
        return None, NO_LIBRARY[pr.fn]
    a = ins[0]

    def loop(step, acc0):
        def run():
            acc = acc0
            for _ in range(iters):
                acc = step(acc)
            return acc
        return run

    if pr.fn == "ew":
        step = lambda acc: torch.addcmul(   # noqa: E731
            torch.add(acc, a, alpha=1.0001), acc, a)
        return loop(step, torch.zeros_like(a)), \
            "torch.addcmul(acc + 1.0001 a, acc, a)"
    if pr.fn == "bmm":
        s = kw.get("s", 1.0)
        return loop(lambda acc: torch.baddbmm(acc, a, torch.add(a, acc,
                                                                alpha=s)),
                    torch.zeros_like(a)), "torch.baddbmm(acc, a, a + s acc)"
    if pr.fn == "mm2d":
        w = a.shape[1]
        top = a[:w]
        return loop(lambda acc: torch.addmm(acc, a + acc, top),
                    torch.zeros_like(a)), "torch.addmm(acc, a + acc, a[:w])"
    if pr.fn == "matvec":
        v, s, trans = ins[1], kw.get("s", 1.0), kw.get("trans", False)
        n, R, C = a.shape
        if trans:
            vv = v[:, :, None]
            return loop(lambda acc: torch.baddbmm(acc, a, vv, beta=s),
                        a.new_zeros((n, R, 1))), \
                "torch.baddbmm(acc, a, v, beta=s)"
        vv = v[:, None, :]
        return loop(lambda acc: torch.baddbmm(acc, vv, a, beta=s),
                    a.new_zeros((n, 1, C))), \
            "torch.baddbmm(acc, v^T, a, beta=s)"
    if pr.fn == "rank1":
        def step(M):
            c = M[:, :, 0:1] * 1e-3
            return torch.baddbmm(M, c, c.transpose(1, 2), alpha=-1.0)
        return loop(step, a), "torch.baddbmm(M, c, c^T, alpha=-1)"
    if pr.fn == "transpose":
        step = lambda acc: torch.add(   # noqa: E731
            torch.add(a, acc, alpha=1e-6).transpose(1, 2), acc, alpha=1e-6)
        return loop(step, torch.zeros_like(a)), \
            "torch.add((a + 1e-6 acc)^T, acc, alpha=1e-6)"
    if pr.fn == "reshape88":
        n = a.shape[0]
        return (lambda: a.reshape(n, 64).add(1.0).reshape(a.shape)), \
            "a.reshape(n, 64).add(1)"
    if pr.fn == "slice_mix":
        out = torch.zeros_like(a)

        def run():
            for _ in range(iters):
                torch.add(a[:, 3, :], a[:, 7, :], out=out[:, 5, :])
            return out
        return run, "torch.add(a[:, 3], a[:, 7], out=acc[:, 5])"
    raise KeyError(name)


def best_ms(fn, reps):
    """The smallest of ``reps`` CUDA-event timings of one call of fn, after
    one call to warm up."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def graph_ms(fn, reps=10):
    """The device time of one call of fn: ``reps`` calls captured in one
    CUDA graph and replayed, the smallest of 3 replays, so no host work
    (ctypes, allocation, launch) sits between the launches. The warm-up
    call runs on a side stream, as PyTorch asks before a capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / reps)
    return best


H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12             # fp32 outside the tensor cores, 700 W
H100_SMS = 132
FMA_PER_SM_CYCLE = {torch.float32: 128, torch.float64: 64}
SM_CLOCK_HZ = 1.98e9                # the clock64 rate read on the card


def sm_floor_ms(name, ins, iters):
    """The least time of a product probe whose dependent steps keep each
    matrix (bmm) or each block's rows (mm2d, 16 a block) on one SM: the
    busiest SM's FMAs at 128 fp32 (64 fp64) FMAs a cycle and 1.98 GHz.
    None for the other functions."""
    pr = PROBES[name]
    a = ins[0]
    if pr.fn == "bmm":
        n, w = a.shape[0], a.shape[-1]
        units, fmas = n, w ** 3
    elif pr.fn == "mm2d":
        rows, w = a.shape
        units = -(-rows // MM2D_ROWS_PER_BLOCK)
        fmas = MM2D_ROWS_PER_BLOCK * w * w
    else:
        return None
    per_sm = -(-units // H100_SMS)
    cycles = per_sm * fmas * iters / FMA_PER_SM_CYCLE[a.dtype]
    return cycles / SM_CLOCK_HZ * 1e3


def measure(name, reps=5, plain_reps=3):
    """Time probe ``name`` on the card at its own steps: the kernel (``ms``
    on the device, from a CUDA graph; ``host_ms`` for the whole launch,
    best of ``reps`` by CUDA events, the host's launch path included as in
    the reference's timing), its plain version, the library loop where
    one exists (``library_ms`` and ``library_host_ms``, the same two
    ways), the bound and, for the products, the per-SM floor
    (``sm_floor_ms``)."""
    pr = PROBES[name]
    iters = pr.iters
    ins = probe_inputs(name)
    kern = lambda: _call(name, ins, iters)   # noqa: E731
    host_ms, ms = best_ms(kern, reps), graph_ms(kern)
    plain_ms = best_ms(lambda: _plain_call(name, ins, iters), plain_reps)
    lib, lib_desc = library(name, ins, iters)
    library_host_ms = None if lib is None else best_ms(lib, reps)
    library_ms = None if lib is None else graph_ms(lib)
    nbytes, flops = work(name, ins, iters)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return dict(label=pr.label, fn=pr.fn, steps=max(iters, 1), ms=ms,
                host_ms=host_ms, us_per_step=ms * 1e3 / max(iters, 1),
                plain_ms=plain_ms, library_ms=library_ms,
                library_host_ms=library_host_ms, library=lib_desc,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations",
                sm_floor_ms=sm_floor_ms(name, ins, iters),
                bytes=nbytes, flops=flops)


def card(device="cuda"):
    """The card's name; a measurement that finds no card fails."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probes measure the card and "
                         "have nothing to say on the CPU")
    return torch.cuda.get_device_name(torch.device(device))
