"""Closed-loop simulation drivers, batch-first (counterpart of
``scpp_tpu/drivers/closed_loop.py``). This slice ports ``mpc_sim``;
``lqr_sim``, ``sc_sim`` and ``sc_tracking`` wait for their algorithms.

The reference's ``lax.scan`` with a frozen-when-done mask becomes a
Python loop over the steps with per-scenario ``torch.where`` masks
(reached_end = ||x - x_final|| < 0.02, SC_sim.cpp:57): every step runs
for every scenario, as the scan does, and no step syncs with the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from scpp_tpu_torch.algos.common import full_fp32, tree_select
from scpp_tpu_torch.algos.mpc import mpc_solve
from scpp_tpu_torch.configs.algorithms import MPCConfig
from scpp_tpu_torch.models.base import map_tensors
from scpp_tpu_torch.ops.simulation import simulate
from scpp_tpu_torch.solver.scs import SolverSettings
from scpp_tpu_torch.trajectory import replace, scenario_where

__all__ = ["mpc_sim", "SimHistory"]


@dataclass
class SimHistory:
    X: torch.Tensor            # (B, steps, n) state after each step
    U: torch.Tensor            # (B, steps, m) applied inputs
    t: torch.Tensor            # (B, steps) time stamps
    steps: torch.Tensor        # (B,) active steps before reached_end
    reached_end: torch.Tensor  # (B,)

    replace = replace


def _reached(x, x_final, tol=0.02):
    return torch.linalg.vector_norm(x - x_final, dim=-1) < tol


def _finite(*arrays):
    """(B,) True where every value of the scenario is finite."""
    ok = None
    for a in arrays:
        f = torch.isfinite(a).reshape(a.shape[0], -1).all(-1)
        ok = f if ok is None else ok & f
    return ok


def mpc_sim(model, params, cfg: MPCConfig = MPCConfig(),
            sim_time: float = 15.0, time_step: float = 0.01,
            device="cuda") -> SimHistory:
    """Receding-horizon MPC closed loop (MPC_sim.cpp:16-91) for every
    scenario of the batched ``params``.

    Each step the plant moves first under the previous input, while the
    controller solves from the step's start state; a non-finite input
    keeps the previous input, a non-finite plant state keeps the state.
    With a first-order solver config (SolverSettings, warm_start=True)
    each re-solve warm-starts from the previous step's iterates, carried
    only where that solve was finite and solved."""
    full_fp32(device)
    params = map_tensors(params, lambda t: t.to(device))
    par = model.param_vector(params)
    n_steps = int(sim_time / time_step)
    x_final = params.x_final
    x = params.x_init
    Bn = x.shape[0]
    use_warm = isinstance(cfg.solver, SolverSettings) and \
        cfg.solver.warm_start
    dt = torch.full((Bn,), time_step, dtype=x.dtype, device=x.device)

    u_prev = x.new_zeros((Bn, model.input_dim))
    # cold solve establishes the warm-start carry
    warm = (mpc_solve(model, params, x, cfg, x_final, device=device)[2]
            if use_warm else None)
    done = torch.zeros((Bn,), dtype=torch.bool, device=x.device)
    Xs, Us, active = [], [], []
    for _ in range(n_steps):
        # plant moves while the controller "solves" (MPC_sim.cpp:67)
        x_mid = simulate(model, par, dt, u_prev, u_prev, x, substeps=4)
        _, U, res = mpc_solve(model, params, x, cfg, x_final, warm,
                              device=device)
        # per-step failure masking: keep the previous input / freeze the
        # state instead of the reference's std::terminate
        u = scenario_where(_finite(U[:, 0]), U[:, 0], u_prev)
        x_next = scenario_where(done | ~_finite(x_mid), x, x_mid)
        u_next = scenario_where(done, u_prev, u)
        active.append(~done)
        done = done | _reached(x_next, x_final)
        # gate the warm carry on solve health: a diverged result would
        # poison every later warm-started solve
        if use_warm:
            warm = tree_select(_finite(U) & res.solved, res, warm)
        x, u_prev = x_next, u_next
        Xs.append(x_next)
        Us.append(u_next)
    ts = time_step * torch.arange(1, n_steps + 1, dtype=x.dtype,
                                  device=x.device)
    return SimHistory(X=torch.stack(Xs, 1), U=torch.stack(Us, 1),
                      t=ts.expand(Bn, n_steps),
                      steps=torch.stack(active, 1).sum(1), reached_end=done)
