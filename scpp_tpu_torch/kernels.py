"""Build and load of the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` (one ``nvcc`` per source, all started together). Libraries go
to ``scpp_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash
of the sources, so an edited source is rebuilt. Nothing here runs at
import time.

``launches`` counts the launches of each kernel; each wrapper adds one
where it launches its kernel and nowhere else. ``solver_calls`` counts
what the solvers ask for, on any device: ``raw_kkt_solve`` is one
single-right-hand-side KKT solve of the unfused staged IPM, which on the
card must equal the ``cr_solve`` launches; ``soc_projection`` is one
projection of a batch's SOC blocks by the first-order conic solver
(``solver/scs.py``), which on the card must equal the ``soc_project``
launches. ``launches["calib_<function>"]`` counts the launches of each
calibration probe function (``diag/calib.py``), one key per name of
``CALIB_FUNCTIONS``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["build", "load", "launches", "solver_calls", "reset_launches",
           "CALIB_FUNCTIONS", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

CALIB_FUNCTIONS = ("ew", "chol_sweep", "bmm", "mm2d", "matvec", "rank1",
                   "chol8flat", "transpose", "reshape88", "slice_mix",
                   "smem_probe")
launches = {"mono_ipm": 0, "disc_mono": 0, "resim_mono": 0, "cr_solve": 0,
            "soc_project": 0,
            **{f"calib_{fn}": 0 for fn in CALIB_FUNCTIONS}}
solver_calls = {"raw_kkt_solve": 0, "soc_projection": 0}
_libs = {}


def reset_launches():
    """Set every count of ``launches`` and ``solver_calls`` to 0."""
    for counts in (launches, solver_calls):
        for name in counts:
            counts[name] = 0


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha256()
    for p in [src] + sorted(_CSRC.glob("*.cuh")):
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False):
    """Compile every source that has no current library, in parallel.
    Returns {name: (seconds, compiler output)} for what it compiled;
    ``verbose`` adds ``-Xptxas -v`` (registers, spills, shared memory)."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    todo = [(src, _lib_path(src)) for src in sorted(_CSRC.glob("*.cu"))]
    todo = [(src, out) for src, out in todo if not out.exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    procs = []
    for src, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((src, out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    report = {}
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        os.replace(tmp, out)
        report[src.stem] = (time.perf_counter() - t0, log)
    return report


def load(name: str):
    """The ctypes library of ``csrc/<name>.cu``, built if needed."""
    if name not in _libs:
        build()
        _libs[name] = ctypes.CDLL(str(_lib_path(_CSRC / f"{name}.cu")))
    return _libs[name]
