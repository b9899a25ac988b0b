"""Stage-banded SCvx subproblem builder, batch-first (counterpart of
``scpp_tpu/algos/staged_problems.py``; the SC builder is not ported yet).

The virtual control uses the stage-local epigraph encoding: the defect
r_k = A x_k + B u_k (+ C u_{k+1}) + z - x_{k+1} is penalized through
-t <= r <= t with cost w_nu * sum(t), which moves the node coupling into
two nonneg cone families and leaves no dynamics equality rows.
"""

from __future__ import annotations

import numpy as np

from scpp_tpu_torch.solver.staged import StagedBuilder
from scpp_tpu_torch.trajectory import DiscretizationData, TrajectoryData

__all__ = ["build_scvx_subproblem_staged"]


def _base_builder(model, td: TrajectoryData):
    K, n_U = td.n_X, td.n_U
    sb = StagedBuilder(K)
    x = sb.stage_var("X", model.state_dim)
    u = sb.stage_var("U", model.input_dim, n_nodes=n_U)
    nu_abs = sb.stage_var("nu_abs", model.state_dim, n_nodes=K - 1)
    return sb, x, u, nu_abs


def _dynamics_and_l1(sb, x, u, nu_abs, dd: DiscretizationData, w_nu,
                     foh: bool):
    r = x.lin(dd.A) + u.lin(dd.B) - x.next.sel() + dd.z
    if foh:
        r = r + u.next.lin(dd.C)
    kn = np.arange(sb.K - 1)
    sb.nonneg(nu_abs.sel() - r, nodes=kn)
    sb.nonneg(nu_abs.sel() + r, nodes=kn)
    sb.cost(nu_abs.sel().sum() * w_nu, nodes=kn)


def build_scvx_subproblem_staged(model, params, td: TrajectoryData,
                                 dd: DiscretizationData, trust_region,
                                 weight_nu, ref, state_trust_region=None):
    """Stage-banded SCvx subproblems of a batch (SCvxProblem.cpp:6-73 +
    model constraints): fixed final time, hard per-node input trust
    region. ``trust_region`` and ``state_trust_region`` are (B,)."""
    n_U = td.n_U
    sb, x, u, nu_abs = _base_builder(model, td)
    _dynamics_and_l1(sb, x, u, nu_abs, dd, weight_nu, td.interpolated_input)

    un = np.arange(n_U)
    sb.soc(trust_region, u.sel() - td.U, nodes=un)
    if state_trust_region is not None:
        sb.soc(state_trust_region, x.sel() - td.X)

    model.constraints_staged(sb, x, u, params, ref, n_U)
    return sb.build(td.X.shape[0], td.X.dtype, td.X.device)
