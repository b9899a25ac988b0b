"""Model protocol (counterpart of ``scpp_tpu/models/base.py``).

A model is a namespace class of pure functions plus a params dataclass
of tensors. ``flow_map(x, u, par)`` works on the last axis, so it takes
one sample or a batch; the Jacobians come from ``torch.func.jacfwd``
vmapped over the batch.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import jacfwd, vmap

__all__ = ["jacobians", "flow_with_jacobians", "map_tensors",
           "batch_params"]


def jacobians(model, x, u, par):
    """A = df/dx (N, n, n), B = df/du (N, n, m) at a batch of points."""
    return vmap(jacfwd(model.flow_map, argnums=(0, 1)))(x, u, par)


def flow_with_jacobians(model, x, u, par):
    """f, A, B in one evaluation, batched over the leading axis."""
    f = model.flow_map(x, u, par)
    A, B = jacobians(model, x, u, par)
    return f, A, B


def map_tensors(obj, fn):
    """Apply ``fn`` to every tensor field of a dataclass."""
    changes = {f.name: fn(getattr(obj, f.name))
               for f in dataclasses.fields(obj)
               if isinstance(getattr(obj, f.name), torch.Tensor)}
    return dataclasses.replace(obj, **changes)


def batch_params(p, n: int):
    """Repeat an unbatched params dataclass ``n`` times on a new leading
    scenario axis."""
    return map_tensors(p, lambda t: t.expand((n,) + t.shape).contiguous())
