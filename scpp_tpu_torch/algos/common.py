"""Shared algorithm helpers (counterpart of ``scpp_tpu/algos/common.py``),
batch-first: every cost is (B,)."""

from __future__ import annotations

import dataclasses

import torch

from scpp_tpu_torch.ops.simulation import simulate
from scpp_tpu_torch.trajectory import TrajectoryData, scenario_where

__all__ = ["full_fp32", "tree_select",
           "interval_resimulation", "nonlinear_defect_cost",
           "linear_defect_cost"]


def full_fp32(device):
    """The reference pins full-fp32 products (precision=HIGHEST): keep
    TF32 off for matmuls and convolutions on the card."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def tree_select(pred, a, b):
    """Per-scenario select pred ? a : b over the tensor fields of two
    dataclasses; ``pred`` is (B,) bool."""
    changes = {}
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            changes[f.name] = scenario_where(pred, x, y)
    return dataclasses.replace(a, **changes)


def interval_resimulation(model, par, td: TrajectoryData, substeps: int = 12,
                          method: str = "dopri5"):
    """Propagate every interval's start state nonlinearly to its end:
    (B, K-1, n)."""
    Bn, K, n = td.X.shape
    m = td.U.shape[-1]
    N = Bn * (K - 1)
    dt = (td.t / (K - 1))[:, None].expand(Bn, K - 1).reshape(N)
    u0 = td.U[:, :K - 1].reshape(N, m)
    u1 = td.U[:, 1:K].reshape(N, m) if td.interpolated_input else u0
    parN = par[:, None, :].expand(Bn, K - 1, par.shape[-1]).reshape(N, -1)
    x_end = simulate(model, parN, dt, u0, u1, td.X[:, :-1].reshape(N, n),
                     substeps, method)
    return x_end.reshape(Bn, K - 1, n)


def nonlinear_defect_cost(model, par, td: TrajectoryData, substeps: int = 12,
                          method: str = "dopri5"):
    """J = sum_k || resim(x_k) - x_{k+1} ||_1 per scenario."""
    x_end = interval_resimulation(model, par, td, substeps, method)
    return torch.sum(torch.abs(x_end - td.X[:, 1:]), dim=(1, 2))


def linear_defect_cost(td: TrajectoryData, dd, sigma=None):
    """L = sum_k || A x_k + B u_k (+ C u_{k+1}) (+ s sigma) + z - x_{k+1} ||_1
    of a subproblem solution, per scenario."""
    K = td.n_X
    x_pred = (torch.einsum("bkij,bkj->bki", dd.A, td.X[:, :-1])
              + torch.einsum("bkij,bkj->bki", dd.B, td.U[:, :K - 1])
              + dd.z)
    if td.interpolated_input:
        x_pred = x_pred + torch.einsum("bkij,bkj->bki", dd.C, td.U[:, 1:])
    if sigma is not None:
        x_pred = x_pred + dd.s * sigma[:, None, None]
    return torch.sum(torch.abs(x_pred - td.X[:, 1:]), dim=(1, 2))
