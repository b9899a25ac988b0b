"""SCvx: successive convexification with a hard trust region and a ratio
test, batch-first (counterpart of ``scpp_tpu/algos/scvx.py``).

One step = discretize -> build the staged subproblems -> staged conic
solve (monolithic or unfused, as ``cfg.solver`` routes it) -> linear and
nonlinear defect costs -> masked accept/reject, for every scenario of
the batch at once. Scenarios that are done are frozen per scenario, and
the loop exits once every scenario is done or the solve budget is
spent; per-step history is recorded per scenario and back-filled past
each scenario's last step, as the reference's batched while-loop does.

Reference quirks kept for numeric parity (SCvxAlgorithm.cpp): the first
subproblem solve is accepted unconditionally; ``last_nonlinear_cost`` is
overwritten even on a rejected step; the exact-minimum-thrust
linearization refreshes once per solve. A failed conic solve (non-finite
iterate, or a linear cost above the incumbent's nonlinear cost) is
masked per scenario: rejected, radius shrunk, previous state kept.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from scpp_tpu_torch.algos.common import (full_fp32, linear_defect_cost,
                                         nonlinear_defect_cost, tree_select)
from scpp_tpu_torch.algos.staged_problems import build_scvx_subproblem_staged
from scpp_tpu_torch.configs.algorithms import SCvxConfig
from scpp_tpu_torch.models.base import map_tensors
from scpp_tpu_torch.ops.disc_mono import (multiple_shooting_fused,
                                          nonlinear_defect_cost_fused)
from scpp_tpu_torch.ops.discretization import multiple_shooting
from scpp_tpu_torch.solver.ipm_staged import (check_unfused_settings,
                                             solve_staged_ipm)
from scpp_tpu_torch.trajectory import TrajectoryData

__all__ = ["SCvxResult", "solve_scvx"]


@dataclass
class SCvxResult:
    td: TrajectoryData            # final (accepted) trajectories
    converged: torch.Tensor       # (B,) bool
    iterations: torch.Tensor      # (B,) accepted iterations
    trust_region: torch.Tensor    # (B,) final radius
    # per-step history (B, solve_budget, ...); slots past a scenario's
    # last step hold that step's values (``accepted`` holds False there)
    all_X: torch.Tensor
    all_U: torch.Tensor
    accepted: torch.Tensor
    nonlinear_cost: torch.Tensor
    linear_cost: torch.Tensor
    res_pri: torch.Tensor
    res_dua: torch.Tensor
    steps: torch.Tensor           # (B,) executed subproblem solves
    max_residual: torch.Tensor    # (B,) worst finite conic residual
    first_failure: torch.Tensor   # (B,) step of the first masked failure


def _no_phase(name):
    return contextlib.nullcontext()


def solve_scvx(model, params, cfg: SCvxConfig = SCvxConfig(),
               warm_td: TrajectoryData = None, device="cuda",
               phase=_no_phase) -> SCvxResult:
    """SCvx solves of a batch of scenarios (SCvxAlgorithm.cpp:166-222).

    ``params`` is a params dataclass with a leading scenario axis;
    ``warm_td`` (dimensional) replaces the initial trajectories.
    ``phase(name)`` returns a context manager wrapped around each phase
    of a step (discretize, build, solve, resim), for timing."""
    if cfg.backend != "staged" or not cfg.l1_split:
        raise NotImplementedError("only backend='staged' with l1_split is "
                                  "ported")
    if not cfg.solver.monolith:
        check_unfused_settings(cfg.solver)
    full_fp32(device)
    params = map_tensors(params, lambda t: t.to(device))
    if cfg.nondimensionalize:
        params = model.nondimensionalize(params)
    par = model.param_vector(params)
    if warm_td is None:
        td = model.init_trajectory(params, cfg.K, cfg.interpolate_input)
    else:
        td = map_tensors(warm_td, lambda t: t.to(device))
        if cfg.nondimensionalize:
            td = model.scale_trajectory(params, td)
    ref = model.constraint_ref(params, td)
    # fuse_dynamics: the discretize and resim phases as one kernel launch
    # each (ops/disc_mono.py), as the reference routes them
    shoot = multiple_shooting_fused if cfg.fuse_dynamics \
        else multiple_shooting
    resim = nonlinear_defect_cost_fused if cfg.fuse_dynamics \
        else nonlinear_defect_cost

    B = td.X.shape[0]
    f = dict(dtype=td.X.dtype, device=td.X.device)
    bool_ = dict(dtype=torch.bool, device=td.X.device)
    int_ = dict(dtype=torch.long, device=td.X.device)
    trust = torch.full((B,), cfg.trust_region, **f)
    last_J = torch.zeros((B,), **f)
    accepts = torch.zeros((B,), **int_)
    converged = torch.zeros((B,), **bool_)
    done = torch.zeros((B,), **bool_)
    max_res = torch.zeros((B,), **f)
    first_fail = torch.full((B,), -1, **int_)
    steps = torch.zeros((B,), **int_)
    warm = None
    has_warm = torch.zeros((B,), **bool_)
    hist = []

    i = 0
    while i < cfg.solve_budget and not bool(done.all()):
        with phase("discretize"):
            dd = shoot(model, par, td, substeps=cfg.substeps,
                       method=cfg.integrator)
        x_trust = (trust * (cfg.state_trust_region / cfg.trust_region)
                   if cfg.state_trust_region else None)
        with phase("build"):
            prog = build_scvx_subproblem_staged(
                model, params, td, dd, trust, cfg.weight_virtual_control,
                ref, x_trust)
        with phase("solve"):
            res = solve_staged_ipm(prog, cfg.solver,
                                   warm if cfg.warm_start else None,
                                   has_warm)
        new_td = td.replace(X=prog.extract(res.x, "X"),
                            U=prog.extract(res.x, "U"))
        with phase("resim"):
            L = linear_defect_cost(new_td, dd)
            J_new = resim(model, par, new_td, cfg.sim_substeps,
                          cfg.integrator)

        first = i == 0
        actual = last_J - J_new
        predicted = last_J - L
        finite_ok = (torch.isfinite(new_td.X).all(dim=(1, 2))
                     & torch.isfinite(new_td.U).all(dim=(1, 2))
                     & torch.isfinite(J_new) & torch.isfinite(L))
        solve_ok = (torch.ones_like(finite_ok) if first
                    else predicted > -cfg.change_threshold)
        step_ok = finite_ok & solve_ok

        conv_now = (torch.zeros_like(finite_ok) if first
                    else torch.abs(predicted) < cfg.change_threshold)
        rho = actual / torch.where(torch.abs(predicted) < 1e-30,
                                   torch.full_like(predicted, 1e-30),
                                   predicted)
        reject = (torch.zeros_like(finite_ok) if first
                  else ~conv_now & (rho < cfg.rho_0))
        reject = reject | ~step_ok
        conv_now = conv_now & step_ok
        accept = ~reject

        shrink = reject | (accept & (rho < cfg.rho_1))
        grow = accept & (rho >= cfg.rho_2)
        trust_new = torch.where(
            shrink, trust / cfg.alpha,
            torch.where(grow, trust * cfg.beta, trust))
        if first:
            trust_new = trust
        trust_new = torch.where(conv_now, trust, trust_new)

        live = ~done
        take = accept & live
        td = tree_select(take, new_td, td)
        last_J = torch.where(done | ~step_ok, last_J, J_new)
        accepts = accepts + take.long()
        converged = converged | (conv_now & live)
        trust = torch.where(done, trust, trust_new)
        step_res = torch.maximum(res.res_pri, res.res_dua)
        max_res = torch.where(done | ~torch.isfinite(step_res), max_res,
                              torch.maximum(max_res, step_res))
        first_fail = torch.where((first_fail < 0) & live & ~step_ok,
                                 torch.full_like(first_fail, i), first_fail)
        if cfg.warm_start:
            warm_good = (finite_ok & torch.isfinite(res.res_pri)
                         & torch.isfinite(res.res_dua))
            fresh = warm_good & live
            warm = tree_select(fresh, res,
                               warm if warm is not None else res)
            has_warm = has_warm | fresh
        hist.append((td.X, td.U, take, J_new, L, res.res_pri, res.res_dua))
        steps = steps + live.long()
        done = done | converged | (accepts >= cfg.max_iterations)
        i += 1

    # history (B, budget, ...): each scenario's slots past its last step
    # repeat that step, except ``accepted``
    budget = cfg.solve_budget
    idx = torch.minimum(torch.arange(budget, device=f["device"])[None, :],
                        torch.clamp_min(steps - 1, 0)[:, None])     # (B, budget)
    n_run = len(hist)

    def stacked(j):
        h = torch.stack([e[j] for e in hist], dim=1)               # (B, n_run, ...)
        gi = torch.clamp_max(idx, n_run - 1)
        gi = gi.reshape(gi.shape + (1,) * (h.dim() - 2)).expand(
            (B, budget) + h.shape[2:])
        return torch.gather(h, 1, gi)

    all_X, all_U, accepted, Js, Ls, rps, rds = (stacked(j) for j in range(7))
    accepted = accepted & (torch.arange(budget, device=f["device"])[None, :]
                           < steps[:, None])
    if cfg.nondimensionalize:
        td = model.unscale_trajectory(params, td)
    return SCvxResult(
        td=td, converged=converged, iterations=accepts, trust_region=trust,
        all_X=all_X, all_U=all_U, accepted=accepted, nonlinear_cost=Js,
        linear_cost=Ls, res_pri=rps, res_dua=rds, steps=steps,
        max_residual=max_res, first_failure=first_fail)
