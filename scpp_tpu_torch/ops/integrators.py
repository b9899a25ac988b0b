"""Fixed-step Runge-Kutta integrators (counterpart of
``scpp_tpu/ops/integrators.py``).

The state may be a tensor or a tuple of tensors; every tensor carries
its batch dimensions in front, so one call integrates every
(scenario x interval) pair in lockstep, as the JAX ``vmap`` did.
"""

from __future__ import annotations

__all__ = ["rk_step", "integrate_fixed", "TABLEAUS"]

# Butcher tableaus: (c nodes, a lower-triangular rows, b weights)
_RK4 = (
    (0.0, 0.5, 0.5, 1.0),
    ((), (0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)),
    (1 / 6, 1 / 3, 1 / 3, 1 / 6),
)

# Dormand-Prince 5(4), 5th-order weights (FSAL stage kept explicit)
_DOPRI5 = (
    (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0),
    ((),
     (1 / 5,),
     (3 / 40, 9 / 40),
     (44 / 45, -56 / 15, 32 / 9),
     (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
     (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
     (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84)),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0),
)

TABLEAUS = {"rk4": _RK4, "dopri5": _DOPRI5}


def _axpy(y, scale_terms):
    """y + sum_i a_i * k_i over a tensor or a tuple of tensors; a_i is a
    Python float or a tensor that broadcasts against each leaf."""
    if isinstance(y, tuple):
        return tuple(_axpy(leaf, [(a, k[i]) for a, k in scale_terms])
                     for i, leaf in enumerate(y))
    out = y
    for a, k in scale_terms:
        out = out + _bc(a, k) * k
    return out


def _bc(a, k):
    """Broadcast a per-batch step size (N,) against a leaf (N, ...)."""
    if isinstance(a, float) or a.dim() == 0:
        return a
    return a.reshape(a.shape + (1,) * (k.dim() - a.dim()))


def rk_step(f, y, t, h, method: str = "dopri5"):
    """One explicit RK step of size h for y' = f(y, t)."""
    c, a_rows, b = TABLEAUS[method]
    ks = []
    for i in range(len(c)):
        yi = _axpy(y, [(h * a_rows[i][j], ks[j])
                       for j in range(i)]) if i else y
        ks.append(f(yi, t + c[i] * h))
    return _axpy(y, [(h * b[i], ks[i]) for i in range(len(ks))
                     if b[i] != 0.0])


def integrate_fixed(f, y0, t0, t1, steps: int, method: str = "dopri5"):
    """Integrate y' = f(y, t) from t0 to t1 in ``steps`` fixed RK steps."""
    h = (t1 - t0) / steps
    y = y0
    for i in range(steps):
        y = rk_step(f, y, t0 + i * h, h, method)
    return y
