"""Algorithm configuration (counterpart of ``SCvxConfig`` in
``scpp_tpu/configs/algorithms.py``; ``.info`` loading and the other
algorithms' configs are not ported yet). Defaults are the stock Rocket2D
SCvx.info values, as in the reference."""

from __future__ import annotations

from dataclasses import dataclass

from scpp_tpu_torch.solver.ipm import IPMSettings

__all__ = ["SCvxConfig"]


@dataclass(frozen=True)
class SCvxConfig:
    """Hard-trust-region SCvx (Mao/Acikmese ratio test), SCvx.info."""
    K: int = 30
    max_iterations: int = 20
    solve_budget: int = 30          # total subproblem solves incl. rejects
    rho_0: float = 0.0
    rho_1: float = 0.25
    rho_2: float = 0.9
    alpha: float = 2.0
    beta: float = 3.2
    change_threshold: float = 1e-2
    weight_virtual_control: float = 1e3
    trust_region: float = 5.0
    state_trust_region: float = 0.0
    nondimensionalize: bool = False
    interpolate_input: bool = True
    substeps: int = 10
    sim_substeps: int = 12
    integrator: str = "dopri5"
    l1_split: bool = True
    backend: str = "staged"
    fuse_dynamics: bool = False
    warm_start: bool = True
    solver: object = IPMSettings(iters=30)
