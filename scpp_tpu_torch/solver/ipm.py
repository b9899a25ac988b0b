"""Interior-point solver settings (counterpart of the ``IPMSettings``
dataclass in ``scpp_tpu/solver/ipm.py``; the dense IPM itself is not
ported yet). Field names and defaults match the reference exactly; see
it for what each knob does.

Where the port differs: ``kkt_fused`` is accepted and changes nothing.
The reference uses it to choose between XLA ops and a fused Pallas KKT
solve, to save TPU dispatch overhead; in the port every
single-right-hand-side KKT solve of the unfused staged IPM launches the
``cr_solve`` CUDA kernel on the card. The unfused solver takes only
``kkt="cr"``, ``kkt_dtype="working"``, ``refine_f64=False`` and
``"highest"`` precisions, and raises ``NotImplementedError`` for the
rest (``solver/ipm_staged.py:check_unfused_settings``)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

__all__ = ["IPMSettings"]


@dataclass(frozen=True)
class IPMSettings:
    iters: int = 25
    step_frac: float = 0.99
    eps_reg: float = 1e-10
    rho_lift: float = 1.0
    eps_feas: float = 1e-9
    ruiz_iters: int = 10
    refine_steps: int = 2
    kkt: str = "cr"
    warm_kappa: float = 0.1
    matmul_precision: str = "highest"
    kkt_precision: str = "highest"
    refine_f64: bool = False
    kkt_dtype: str = "working"
    kkt_fused: bool = False
    monolith: bool = False
    mono_track_best: bool = True

    def replace(self, **changes) -> "IPMSettings":
        return dataclasses.replace(self, **changes)
