"""Algorithm configuration (counterpart of ``SCvxConfig`` and
``MPCConfig`` in ``scpp_tpu/configs/algorithms.py``; ``.info`` loading
and the other algorithms' configs are not ported yet). Defaults are the
stock Rocket2D SCvx.info and MPC.info values, as in the reference."""

from __future__ import annotations

from dataclasses import dataclass

from scpp_tpu_torch.solver.ipm import IPMSettings

__all__ = ["SCvxConfig", "MPCConfig"]


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


@dataclass(frozen=True)
class MPCConfig:
    """Linear receding-horizon SOCP MPC, MPC.info.

    ``solver``: the production backend is the dense IPM (default); a
    first-order HSD backend (``solver.scs.SolverSettings``) is also
    accepted, an experimental oracle in the reference (float32 warm
    re-solves stall near 5e-4 residuals). ``nondimensionalize`` and
    ``constant_dynamics`` are parsed for MPC.info compatibility and read
    by nothing, as in the reference: the dynamics matrices are inputs of
    every solve, so both reference modes behave the same."""

    K: int = 7
    time_horizon: float = 1.5
    nondimensionalize: bool = False
    constant_dynamics: bool = True
    intermediate_cost_active: bool = False
    state_weights_intermediate: tuple = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
    state_weights_terminal: tuple = (5.0, 5.0, 5.0, 1.0, 1.0, 1.0)
    input_weights: tuple = (0.1, 0.1)
    solver: object = IPMSettings(iters=20)
