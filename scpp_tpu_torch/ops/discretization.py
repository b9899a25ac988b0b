"""Multiple-shooting discretization of the linearized dynamics
(counterpart of ``scpp_tpu/ops/discretization.py``).

For every (scenario x interval) pair at once, integrate the forward
variational equation Y' = A(t) Y + R(t) of the augmented state
Y = [Phi | Y_B | (Y_C) | y_z] with fixed-step RK and read A_k, B_k, C_k,
z_k off Y(dt). This slice ports the fixed-final-time variant only (the
reference's ``variable_time=False``); FOH and ZOH both work.

:func:`exact_linear_discretization` is the MPC's: the exact ZOH
discretization about an equilibrium by matrix exponential.
"""

from __future__ import annotations

import torch

from scpp_tpu_torch.models.base import flow_with_jacobians
from scpp_tpu_torch.ops.integrators import integrate_fixed
from scpp_tpu_torch.trajectory import DiscretizationData, TrajectoryData

__all__ = ["multiple_shooting", "exact_linear_discretization"]


def _interval_ode(model, par, u0, u1, dt, interpolate_input):
    """RHS of the fixed-time variational ODE on a flat batch of N
    intervals: x (N, n), Y (N, n, cols), t and dt (N,)."""

    def f(V, t):
        x, Y = V
        if interpolate_input:
            u = u0 + (t / dt)[:, None] * (u1 - u0)
        else:
            u = u0
        fx, A, B = flow_with_jacobians(model, x, u, par)
        r = fx - (A @ x[..., None])[..., 0] - (B @ u[..., None])[..., 0]
        cols = [torch.zeros_like(A)]
        if interpolate_input:
            alpha = ((dt - t) / dt)[:, None, None]
            beta = (t / dt)[:, None, None]
            cols += [B * alpha, B * beta]
        else:
            cols.append(B)
        cols.append(r[..., None])
        R = torch.cat(cols, dim=-1)
        return (fx, A @ Y + R)

    return f


def multiple_shooting(model, par, td: TrajectoryData, sigma=None,
                      substeps: int = 10,
                      method: str = "dopri5") -> DiscretizationData:
    """Discretize the dynamics around a batch of trajectories at a fixed
    final time. ``par`` (B, p); ``td`` batch-first."""
    foh = td.interpolated_input
    Bn, K, n = td.X.shape
    m = model.input_dim
    N = Bn * (K - 1)
    time = td.t if sigma is None else sigma
    dt = (1.0 / (K - 1)) * time                          # (B,)

    x0 = td.X[:, :-1].reshape(N, n)
    u0 = td.U[:, :K - 1].reshape(N, m)
    u1 = td.U[:, 1:K].reshape(N, m) if foh else u0
    dtN = dt[:, None].expand(Bn, K - 1).reshape(N)
    parN = par[:, None, :].expand(Bn, K - 1, par.shape[-1]).reshape(N, -1)

    n_cols = n + m + (m if foh else 0) + 1
    eye = torch.eye(n, dtype=td.X.dtype, device=td.X.device)
    Y0 = torch.cat([eye.expand(N, n, n),
                    torch.zeros(N, n, n_cols - n, dtype=td.X.dtype,
                                device=td.X.device)], dim=-1)
    f = _interval_ode(model, parN, u0, u1, dtN, foh)
    _, Y = integrate_fixed(f, (x0, Y0), 0.0 * dtN, dtN, substeps, method)
    Y = Y.reshape(Bn, K - 1, n, n_cols)
    return DiscretizationData(
        A=Y[..., :n], B=Y[..., n:n + m], z=Y[..., -1],
        C=Y[..., n + m:n + 2 * m] if foh else None)


def exact_linear_discretization(model, par, ts, x_eq, u_eq):
    """Equilibrium ZOH discretization via matrix exponential, batched:
    ``par`` (B, p), ``x_eq`` (B, n), ``u_eq`` (B, m), ``ts`` a float.

    Parity with discretization.cpp:9-40: A, B from
    expm([[Ac, Bc], [0, 0]] ts) and the affine term z from
    expm([[Ac, f - Ac x - Bc u], [0, 0]] ts). Returns A (B, n, n),
    B (B, n, m), z (B, n)."""
    fx, A_c, B_c = flow_with_jacobians(model, x_eq, u_eq, par)
    n, m = model.state_dim, model.input_dim
    Bn = x_eq.shape[0]

    E = x_eq.new_zeros((Bn, n + m, n + m))
    E[:, :n, :n] = A_c
    E[:, :n, n:] = B_c
    expE = torch.linalg.matrix_exp(E * ts)
    A = expE[:, :n, :n]
    B = expE[:, :n, n:]

    E2 = x_eq.new_zeros((Bn, n + 1, n + 1))
    r = fx - (A_c @ x_eq[..., None])[..., 0] - (B_c @ u_eq[..., None])[..., 0]
    E2[:, :n, :n] = A_c
    E2[:, :n, n] = r
    expE2 = torch.linalg.matrix_exp(E2 * ts)
    z = expE2[:, :n, n]
    return A, B, z
