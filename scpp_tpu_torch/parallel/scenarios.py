"""Scenario batching (counterpart of ``disperse_initial_state`` in
``scpp_tpu/parallel/scenarios.py``; single device, no sharding yet)."""

from __future__ import annotations

from scpp_tpu_torch.models.base import batch_params

__all__ = ["disperse_initial_state"]


def disperse_initial_state(model, params, generator, n: int, scale):
    """``n`` scenario params with feasible dispersed initial states, from
    an unbatched nominal ``params`` and a ``torch.Generator`` (the same
    kind of dispersion as the reference's, not the same numbers: the
    reference draws from jax.random). Lives on the generator's device."""
    x_init = model.disperse_x_init(params, generator, n, scale)
    pb = batch_params(params, n)
    return pb.replace(x_init=x_init.to(device=pb.x_init.device,
                                       dtype=pb.x_init.dtype))
