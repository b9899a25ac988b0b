"""The JAX package's objects, given as numpy arrays or plain fields,
turned into the port's objects, so that both packages compute on the
same inputs. Nothing here imports JAX: the caller reads the fields (for
example with ``numpy.asarray``) and passes them in.

Every converted tensor gets the port's leading scenario axis; inputs that
already carry one (a vmapped batch) pass ``batched=True``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from scpp_tpu_torch.solver.builder import ConicProgram
from scpp_tpu_torch.solver.ipm import IPMSettings
from scpp_tpu_torch.solver.ipm_staged import StagedSolverResult
from scpp_tpu_torch.solver.scs import SolverResult, SolverSettings
from scpp_tpu_torch.solver.staged import StagedProgram
from scpp_tpu_torch.trajectory import DiscretizationData, TrajectoryData

__all__ = ["tensor", "params", "trajectory", "discretization",
           "staged_program", "staged_solver_result", "ipm_settings",
           "conic_program", "solver_result", "solver_settings"]


def _get(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def tensor(a, batched: bool = False, dtype=None, device="cpu"):
    """An array as a tensor, with a unit scenario axis unless batched."""
    t = torch.as_tensor(np.array(a), dtype=dtype, device=device)
    return t if batched else t[None]


def _fields(cls, src, names, batched, dtype, device, optional=()):
    out = {}
    for f in dataclasses.fields(cls):
        if f.name not in names:
            continue
        v = _get(src, f.name) if (f.name not in optional
                                  or _has(src, f.name)) else None
        out[f.name] = (None if v is None
                       else tensor(v, batched, dtype, device))
    return out


def _has(src, name):
    return (name in src) if isinstance(src, dict) else (
        getattr(src, name, None) is not None)


def params(model, src, batched: bool = False, dtype=None, device="cpu"):
    """A model's params dataclass from the reference's params (tensor
    fields as arrays, structure flags as bools)."""
    kw = {}
    for f in dataclasses.fields(model.Params):
        v = _get(src, f.name)
        kw[f.name] = (bool(v) if isinstance(v, (bool, np.bool_))
                      else tensor(v, batched, dtype, device))
    return model.Params(**kw)


def trajectory(src, batched: bool = False, dtype=None, device="cpu"):
    return TrajectoryData(**_fields(TrajectoryData, src, ("X", "U", "t"),
                                    batched, dtype, device))


def discretization(src, batched: bool = False, dtype=None, device="cpu"):
    return DiscretizationData(**_fields(
        DiscretizationData, src, ("A", "B", "z", "C", "s"), batched, dtype,
        device, optional=("C", "s")))


_PROG_ARRAYS = ("A_eq", "b_eq", "G", "h", "A_geq", "b_geq", "G_g", "h_g",
                "c_stage", "c_glob")


def staged_program(src, batched: bool = False, dtype=None, device="cpu"):
    kw = _fields(StagedProgram, src, _PROG_ARRAYS, batched, dtype, device)
    for name in ("K", "w", "g", "l", "l_g"):
        kw[name] = int(_get(src, name))
    for name in ("soc_sizes", "soc_sizes_g"):
        kw[name] = tuple(int(q) for q in _get(src, name))
    kw["stage_layout"] = tuple(
        (str(n), int(o), int(d), int(k)) for n, o, d, k in
        _get(src, "stage_layout"))
    kw["glob_layout"] = tuple(
        (str(n), int(o), int(s)) for n, o, s in _get(src, "glob_layout"))
    return StagedProgram(**kw)


def staged_solver_result(src, batched: bool = False, dtype=None,
                         device="cpu"):
    names = [f.name for f in dataclasses.fields(StagedSolverResult)]
    return StagedSolverResult(**_fields(StagedSolverResult, src, names,
                                        batched, dtype, device,
                                        optional=names[6:]))


def ipm_settings(src) -> IPMSettings:
    """IPMSettings with the reference settings' field values."""
    return IPMSettings(**{f.name: _get(src, f.name)
                          for f in dataclasses.fields(IPMSettings)})


def conic_program(src, batched: bool = False, dtype=None, device="cpu"):
    """A ConicProgram from the reference's (A, b, c and its static cone
    layout)."""
    kw = {n: tensor(_get(src, n), batched, dtype, device)
          for n in ("A", "b", "c")}
    kw["n_eq"] = int(_get(src, "n_eq"))
    kw["n_ineq"] = int(_get(src, "n_ineq"))
    kw["soc_sizes"] = tuple(int(q) for q in _get(src, "soc_sizes"))
    kw["var_layout"] = tuple(
        (str(nm), int(off), tuple(int(d) for d in shape))
        for nm, off, shape in _get(src, "var_layout"))
    return ConicProgram(**kw)


def solver_result(src, batched: bool = False, dtype=None, device="cpu"):
    return SolverResult(**{f.name: tensor(_get(src, f.name), batched, dtype,
                                          device)
                           for f in dataclasses.fields(SolverResult)})


def solver_settings(src) -> SolverSettings:
    """SolverSettings with the reference settings' field values."""
    return SolverSettings(**{f.name: _get(src, f.name)
                             for f in dataclasses.fields(SolverSettings)})
