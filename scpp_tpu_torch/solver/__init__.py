"""Conic modelling and solvers (counterpart of ``scpp_tpu/solver``)."""

from scpp_tpu_torch.solver.affine import Aff, Var, concat  # noqa: F401
from scpp_tpu_torch.solver.builder import ConeProblemBuilder, ConicProgram  # noqa: F401
from scpp_tpu_torch.solver.scs import SolverSettings, SolverResult, solve_conic  # noqa: F401
from scpp_tpu_torch.solver.ipm import IPMSettings, solve_conic_ipm  # noqa: F401


def solve(prog, settings, warm=None):
    """Backend dispatch: IPMSettings -> dense interior-point (accuracy,
    ~25 iters), SolverSettings -> first-order HSD splitting (cheap iters,
    warm-startable)."""
    if isinstance(settings, IPMSettings):
        return solve_conic_ipm(prog, settings)
    return solve_conic(prog, settings, warm)
