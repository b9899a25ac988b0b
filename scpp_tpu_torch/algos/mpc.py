"""Linear receding-horizon SOCP MPC, batch-first (counterpart of
``scpp_tpu/algos/mpc.py``).

Dynamics linearized about the model's operating point with the exact
ZOH discretization (matrix exponential, dt = time_horizon/(K-1)), then
one SOCP per scenario with only ``x_init`` changing between re-solves
(MPCProblem.cpp:6-89, MPCAlgorithm.cpp:11-141).

Cost: || w_terminal o (x_K - x_final) ||_2 (+ intermediate-node rows
when enabled; the reference's intermediate-cost indexing bug at
MPCProblem.cpp:64-68 is not replicated, as in the JAX package) +
|| w_u o u ||_2, each via a scalar epigraph variable. Pass model params
with ``constrain_initial_final`` off, as the reference's MPC configs do.
"""

from __future__ import annotations

import numpy as np

from scpp_tpu_torch.algos.common import full_fp32
from scpp_tpu_torch.configs.algorithms import MPCConfig
from scpp_tpu_torch.models.base import map_tensors
from scpp_tpu_torch.ops.discretization import exact_linear_discretization
from scpp_tpu_torch.solver import ConeProblemBuilder, concat, solve

__all__ = ["build_mpc_subproblem", "mpc_program", "mpc_solve"]


def build_mpc_subproblem(model, cfg: MPCConfig, A, B, z, x_init, x_final,
                         params, ref=(), dtype=None):
    """The MPC SOCPs of a batch (MPCProblem.cpp:6-89 + model
    constraints): A (B, n, n), B (B, n, m), z, x_init, x_final (B, n)."""
    K = cfg.K
    n, m = model.state_dim, model.input_dim
    dtype = dtype or x_init.dtype

    pb = ConeProblemBuilder()
    X = pb.add_variable("X", K, n)
    U = pb.add_variable("U", K - 1, m)
    err = pb.add_variable("error_cost")
    inp = pb.add_variable("input_cost")

    # initial state pinned (MPCProblem.cpp:28-31)
    pb.add_eq(X[0] - x_init)

    # time-invariant linear dynamics (MPCProblem.cpp:33-55)
    for k in range(K - 1):
        pb.add_eq(X.place(A, k) + U.place(B, k) - X[k + 1] + z)

    # error cost epigraph (MPCProblem.cpp:57-72)
    w_term = np.asarray(cfg.state_weights_terminal, dtype=np.float64)
    parts = []
    if cfg.intermediate_cost_active:
        w_int = np.asarray(cfg.state_weights_intermediate, dtype=np.float64)
        for k in range(1, K - 1):
            parts.append((X[k] - x_final) * w_int)
    parts.append((X[K - 1] - x_final) * w_term)
    pb.add_soc(err[...], concat(parts))
    pb.add_cost(err[...])

    # input cost epigraph (MPCProblem.cpp:74-84)
    w_u = np.asarray(cfg.input_weights, dtype=np.float64)
    pb.add_soc(inp[...], concat([U[k] * w_u for k in range(K - 1)]))
    pb.add_cost(inp[...])

    model.constraints(pb, X, U, params, ref)
    return pb.build(dtype)


def mpc_program(model, params, x_init, cfg: MPCConfig = MPCConfig(),
                x_final=None):
    """The MPC SOCPs that :func:`mpc_solve` solves, for params, x_init
    and x_final already on one device: the linearization about the
    operating point (MPCAlgorithm.cpp:45-52 does it once at init; the
    reference's jit folds it to a constant) and the build."""
    par = model.param_vector(params)
    x_final = params.x_final if x_final is None else x_final
    x_eq, u_eq = model.operating_point(params)
    dt = cfg.time_horizon / (cfg.K - 1)
    A, B, z = exact_linear_discretization(model, par, dt, x_eq, u_eq)
    ref = model.constraint_ref(
        params, model.init_trajectory(params, cfg.K, False))
    return build_mpc_subproblem(model, cfg, A, B, z, x_init, x_final,
                                params, ref)


def mpc_solve(model, params, x_init, cfg: MPCConfig = MPCConfig(),
              x_final=None, warm=None, device="cuda"):
    """One receding-horizon solve per scenario: returns (X (B, K, n),
    U (B, K-1, m), result).

    ``params`` carry the scenario axis in front; ``x_init`` (and
    ``x_final``, default ``params.x_final``) are (B, n); all are moved
    to ``device``. ``warm`` (a previous SolverResult, on the device)
    warm-starts the first-order backend when ``cfg.solver`` is a
    SolverSettings with ``warm_start=True`` (MPCAlgorithm.cpp:93-116)."""
    full_fp32(device)
    params = map_tensors(params, lambda t: t.to(device))
    x_final = None if x_final is None else x_final.to(device)
    prog = mpc_program(model, params, x_init.to(device), cfg, x_final)
    res = solve(prog, cfg.solver, warm)
    return prog.extract(res.x, "X"), prog.extract(res.x, "U"), res
