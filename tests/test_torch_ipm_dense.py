"""PyTorch port vs the JAX package: the dense interior-point SOCP solver
(``solver/ipm.py:solve_conic_ipm``), the MPC's default backend, in
float64 on the CPU: x, y, s and the residuals to 1e-8 relative to
1 + max |ref|, the objective to 1e-10.

On the MPC program the reference is its own ``mpc_solve`` (the same
solve of the same program; its compile is shared with
test_torch_mpc.py).
"""

import jax
import numpy as np
import pytest
import torch

from scpp_tpu.solver import ConeProblemBuilder as JBuilder
from scpp_tpu.solver.ipm import IPMSettings as JIPMSettings
from scpp_tpu.solver.ipm import solve_conic_ipm as j_ipm
from scpp_tpu_torch.algos.mpc import mpc_program
from scpp_tpu_torch.models import Rocket2D
from scpp_tpu_torch.solver import ConeProblemBuilder
from scpp_tpu_torch.solver.ipm import IPMSettings, solve_conic_ipm
from test_torch_conic import (port_config, port_mpc_params, random_socp,
                              reference_mpc_solve)

F64 = torch.float64
FIELDS = ("x", "y", "s", "res_pri", "res_dua", "res_gap")


@jax.jit
def j_ipm_eps(prog, eps_reg):
    """The reference's solve_conic_ipm with IPMSettings(eps_reg=eps_reg),
    the regularization a traced argument: it only scales an identity
    there, so one compile per program shape serves the default 1e-10 and
    the failed-factor test's negative values."""
    return j_ipm.__wrapped__(prog, JIPMSettings(eps_reg=eps_reg))


def rel(got, ref):
    got, ref = got.numpy(), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / (1 + np.max(np.abs(ref))))


def assert_close(res, ref, i=0):
    for n in FIELDS:
        assert rel(getattr(res, n)[i], getattr(ref, n)) <= 1e-8, n
    assert abs(float(res.obj[i]) - float(ref.obj)) <= \
        1e-10 * (1 + abs(float(ref.obj)))


class _Fields:
    def __init__(self, d):
        self.__dict__.update(d)


def test_mpc_program_matches_reference():
    ref = _Fields(reference_mpc_solve("ipm"))
    p = port_mpc_params()
    res = solve_conic_ipm(mpc_program(Rocket2D, p, p.x_init,
                                      port_config("stock")),
                          IPMSettings(iters=20))
    assert_close(res, ref)
    assert float(res.res_pri[0]) < 1e-9 and float(res.res_gap[0]) < 1e-9


@pytest.mark.parametrize("n_eq", [2, 0], ids=["with_eq", "without_eq"])
def test_random_socp_matches_reference(n_eq):
    """test_solver.py's random SOCP, with and without equality rows (the
    ne == 0 branches of the factor and the Schur pass)."""
    ref = j_ipm_eps(random_socp(JBuilder, 3, n_eq), JIPMSettings().eps_reg)
    res = solve_conic_ipm(random_socp(ConeProblemBuilder, 3, n_eq, F64))
    assert_close(res, ref)
    assert float(res.res_pri[0]) < 1e-8 and float(res.res_dua[0]) < 1e-8


def test_batch_equals_single_solves():
    """Three MPC programs at different x_init solved as one batch equal
    three single solves: x, s, the objective and the residuals to the
    tolerances held against the reference, y to 5e-8. The two differ only
    in the batched products' rounding, and these solves determine the
    duals to about 1e-8: the reference's own vmapped and single solves of
    the scenario at 1.3 x_init differ by 1.0e-8 on y."""
    p = port_mpc_params(3)
    x = p.x_init * torch.tensor([1.0, 1.3, 0.7], dtype=F64)[:, None]
    cfg = port_config("stock")
    batch = solve_conic_ipm(mpc_program(Rocket2D, p, x, cfg), cfg.solver)
    one = port_mpc_params(1)
    for i in range(3):
        res = solve_conic_ipm(mpc_program(Rocket2D, one, x[i:i + 1], cfg),
                              cfg.solver)
        for n in FIELDS + ("obj",):
            tol = 5e-8 if n == "y" else 1e-8
            assert rel(getattr(batch, n)[i], getattr(res, n)[0]) <= tol, n


def test_failed_factor_is_nan_and_freezes_as_in_jax():
    """A negative regularization makes the reduced KKT matrix indefinite.
    At -1e-3 a factor fails mid-solve: the iterate freezes there and both
    packages return the same finite, unconverged best iterate. At -0.5
    the very first factor fails and every output is NaN, as the
    reference returns it (read once while writing this test: all of its
    x, y, s and residuals are NaN)."""
    ref = j_ipm_eps(random_socp(JBuilder, 0, 2), -1e-3)
    res = solve_conic_ipm(random_socp(ConeProblemBuilder, 0, 2, F64),
                          IPMSettings(eps_reg=-1e-3))
    assert torch.isfinite(res.x).all()
    assert float(res.res_pri[0]) > 1e-3
    assert_close(res, ref)
    res = solve_conic_ipm(random_socp(ConeProblemBuilder, 0, 2, F64),
                          IPMSettings(eps_reg=-0.5))
    for n in ("x", "y", "obj", "res_pri", "res_dua", "res_gap"):
        assert torch.isnan(getattr(res, n)).all(), n
    # the slacks of the two equality rows are zero by construction
    assert torch.equal(res.s[:, :2], torch.zeros((1, 2), dtype=F64))
    assert torch.isnan(res.s[:, 2:]).all()
