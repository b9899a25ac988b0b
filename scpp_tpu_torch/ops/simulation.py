"""Nonlinear propagation (counterpart of ``scpp_tpu/ops/simulation.py``)."""

from __future__ import annotations

from scpp_tpu_torch.ops.integrators import integrate_fixed

__all__ = ["simulate"]


def simulate(model, par, dt, u0, u1, x, substeps: int = 12,
             method: str = "dopri5"):
    """Propagate x (N, n) over [0, dt] under u(t) = u0 + t/dt (u1 - u0).

    ``dt`` is (N,); ``par`` (N, p); ``u0``/``u1`` (N, m)."""
    flow = model.flow_map

    def f(y, t):
        u = u0 + (t / dt)[:, None] * (u1 - u0)
        return flow(y, u, par)

    return integrate_fixed(f, x, 0.0 * dt, dt, substeps, method)
