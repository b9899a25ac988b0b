"""Scenario batching (counterpart of ``disperse_initial_state`` in
``scpp_tpu/parallel/scenarios.py``; single device, no sharding yet)."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from scpp_tpu_torch.models.base import batch_params

__all__ = ["disperse_initial_state", "bench_initial_states"]

_BENCH_X_INIT = Path(__file__).resolve().parent / "bench_x_init.txt"


def disperse_initial_state(model, params, generator, n: int, scale):
    """``n`` scenario params with feasible dispersed initial states, from
    an unbatched nominal ``params`` and a ``torch.Generator`` (the same
    kind of dispersion as the reference's, not the same numbers: the
    reference draws from jax.random). Lives on the generator's device."""
    x_init = model.disperse_x_init(params, generator, n, scale)
    pb = batch_params(params, n)
    return pb.replace(x_init=x_init.to(device=pb.x_init.device,
                                       dtype=pb.x_init.dtype))


def bench_initial_states(dtype=torch.float32, device="cpu"):
    """The (64, 14) RocketQuat initial states of the 64 scenarios that
    ``bench.py`` solves, as float32 values from the reference's
    ``disperse_initial_state(RocketQuat, default_params(), PRNGKey(0), 64,
    scale=2.0)``, stored in ``bench_x_init.txt`` beside this module (the
    reference draws them from jax.random, which the port does not
    reproduce)."""
    x = np.loadtxt(_BENCH_X_INIT, dtype=np.float32, ndmin=2)
    return torch.as_tensor(x).to(dtype=dtype, device=device)
