"""Trajectory and discretization containers, batch-first.

Counterpart of ``scpp_tpu/trajectory.py``: ``X: (B, K, n)``,
``U: (B, n_U, m)`` with FOH iff ``n_U == K``, final time ``t: (B,)``;
``A: (B, K-1, n, n)`` etc. ``C is None`` means ZOH and ``s is None``
means fixed final time, as in the reference.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

__all__ = ["TrajectoryData", "DiscretizationData", "replace",
           "scenario_where"]


def replace(obj, **changes):
    """``dataclasses.replace`` under the name the JAX structs use."""
    return dataclasses.replace(obj, **changes)


def scenario_where(pred, a, b):
    """pred ? a : b per scenario: ``pred`` (B,) bool, a and b (B, ...)."""
    return torch.where(pred.reshape(pred.shape + (1,) * (a.dim() - 1)), a, b)


@dataclass
class TrajectoryData:
    X: torch.Tensor
    U: torch.Tensor
    t: torch.Tensor

    @property
    def n_X(self) -> int:
        return self.X.shape[-2]

    @property
    def n_U(self) -> int:
        return self.U.shape[-2]

    @property
    def interpolated_input(self) -> bool:
        return self.U.shape[-2] == self.X.shape[-2]

    replace = replace


@dataclass
class DiscretizationData:
    A: torch.Tensor
    B: torch.Tensor
    z: torch.Tensor
    C: Optional[torch.Tensor] = None
    s: Optional[torch.Tensor] = None

    @property
    def interpolated_input(self) -> bool:
        return self.C is not None

    @property
    def variable_time(self) -> bool:
        return self.s is not None

    replace = replace
