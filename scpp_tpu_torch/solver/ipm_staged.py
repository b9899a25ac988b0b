"""Staged IPM front end, batch-first (counterpart of
``scpp_tpu/solver/ipm_staged.py``).

This slice ports what the monolithic path needs: the result container,
the Ruiz equilibration and the router. The unfused staged solver
(``_solve_impl``, ``staged_kkt``, ``cr_pallas``) is not ported yet, so
``solve_staged_ipm`` raises for every program that the monolith does
not take.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from scpp_tpu_torch.solver.ipm import IPMSettings
from scpp_tpu_torch.solver.staged import StagedProgram
from scpp_tpu_torch.trajectory import replace

__all__ = ["solve_staged_ipm", "StagedSolverResult"]


@dataclass
class StagedSolverResult:
    x_stage: torch.Tensor       # (B, K, w)
    x_glob: torch.Tensor        # (B, g)
    obj: torch.Tensor           # (B,)
    res_pri: torch.Tensor       # (B,)
    res_dua: torch.Tensor       # (B,)
    res_gap: torch.Tensor       # (B,)
    y_stage: torch.Tensor = None   # (B, K, me)
    y_glob: torch.Tensor = None    # (B, meg)
    z_stage: torch.Tensor = None   # (B, K, mc)
    z_glob: torch.Tensor = None    # (B, mcg)

    replace = replace

    @property
    def x(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.x_stage, self.x_glob)


def _soc_offs(l, soc_sizes):
    offs = []
    off = l
    for q in soc_sizes:
        offs.append(off)
        off += q
    return tuple(offs)


def _staged_ruiz(prog: StagedProgram, iters: int):
    """Ruiz equilibration on the staged layout of a batch without a
    global block: column scales E_st (B, K, w), row scales d_eq (B, K, me)
    and d_c (B, K, mc), uniform within each SOC block."""
    if prog.g or prog.A_geq.shape[-2] or prog.G_g.shape[-2]:
        raise NotImplementedError("global rows are not ported yet")
    K, w = prog.K, prog.w
    A_eq, G = prog.A_eq, prog.G
    B = A_eq.shape[0]
    ones = dict(dtype=A_eq.dtype, device=A_eq.device)
    E_st = torch.ones((B, K, w), **ones)
    d_eq = torch.ones(A_eq.shape[:3], **ones)
    d_c = torch.ones(G.shape[:3], **ones)
    offs = _soc_offs(prog.l, prog.soc_sizes)

    def colscale_cat(E):
        E_next = torch.cat([E[:, 1:], torch.ones((B, 1, w), **ones)], 1)
        return torch.cat([E, E_next], dim=2)                  # (B, K, 2w)

    def soc_uniform(r):
        parts = [r[..., :prog.l]]
        for o, q in zip(offs, prog.soc_sizes):
            m = torch.amax(r[..., o:o + q], dim=-1, keepdim=True)
            parts.append(m.expand(B, K, q))
        return torch.cat(parts, dim=-1)

    def rowscale(d, r):
        # all-zero rows (padded families) stay unscaled
        return torch.where(r < 1e-12, d, d / torch.sqrt(torch.clamp_min(
            r, 1e-12)))

    for _ in range(iters):
        Ecat = colscale_cat(E_st)[:, :, None, :]
        r_eq = torch.amax(torch.abs(A_eq * d_eq[..., None] * Ecat), dim=3)
        r_c = soc_uniform(torch.amax(torch.abs(G * d_c[..., None] * Ecat),
                                     dim=3))
        d_eq = rowscale(d_eq, r_eq)
        d_c = rowscale(d_c, r_c)

        both = torch.cat([A_eq * d_eq[..., None] * Ecat,
                          G * d_c[..., None] * Ecat], dim=2)
        colmax = torch.amax(torch.abs(both), dim=2)           # (B, K, 2w)
        cm_next = torch.cat([torch.zeros((B, 1, w), **ones),
                             colmax[:, :-1, w:2 * w]], dim=1)
        cmax = torch.maximum(colmax[..., :w], cm_next)
        # empty columns (the virtual control's padded copy) stay unscaled
        E_st = torch.where(cmax < 1e-12, E_st,
                           E_st / torch.sqrt(torch.clamp_min(cmax, 1e-12)))
    return E_st, d_eq, d_c


def solve_staged_ipm(prog: StagedProgram,
                     settings: IPMSettings = IPMSettings(),
                     warm: StagedSolverResult = None,
                     warm_ok=False) -> StagedSolverResult:
    """Solve a batch of staged conic programs.

    ``warm`` is a previous result on same-structured programs and
    ``warm_ok`` (bool or (B,) bool) selects warm or cold per scenario.
    ``settings.monolith`` routes supported programs (gm == 0, full
    precision) to the monolithic solve (solver/ipm_mono.py); the unfused
    solver is not ported, so anything else raises."""
    from scpp_tpu_torch.solver.ipm_mono import (mono_supported,
                                                solve_staged_ipm_mono)
    if settings.monolith and mono_supported(prog, settings):
        return solve_staged_ipm_mono(prog, settings, warm, warm_ok)
    raise NotImplementedError(
        "only the monolithic staged IPM is ported: it needs "
        "IPMSettings(monolith=True) and a program without global rows")
