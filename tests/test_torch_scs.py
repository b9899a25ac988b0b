"""PyTorch port vs the JAX package: the first-order conic solver
(``solver/scs.py``) on the MPC program and on test_solver.py's random
SOCP, in float64 on the CPU.

The reference runs with ``use_pallas=False``: its Pallas path does not
run on the CPU (``scs.py:107`` calls the kernel outside interpret mode),
and it computes the same function. Plain Douglas-Rachford
(``aa_memory=0``) agrees to 1e-9 relative to 1 + max |ref|, Anderson
acceleration to 1e-8 (its small least-squares solve amplifies the two
packages' rounding differences).
"""

import jax
import numpy as np
import pytest
import torch

from scpp_tpu.solver import ConeProblemBuilder as JBuilder
from scpp_tpu.solver.builder import ConicProgram as JConicProgram
from scpp_tpu.solver.scs import SolverResult as JSolverResult
from scpp_tpu.solver.scs import SolverSettings as JSolverSettings
from scpp_tpu.solver.scs import project_dual_cone as j_dual
from scpp_tpu.solver.scs import project_primal_cone as j_primal
from scpp_tpu.solver.scs import solve_conic as j_solve_conic
from scpp_tpu_torch import convert, kernels
from scpp_tpu_torch.algos.mpc import mpc_program
from scpp_tpu_torch.models import Rocket2D
from scpp_tpu_torch.solver import scs
from test_torch_conic import (port_config, port_mpc_params, program_fields,
                              random_socp, reference_mpc_solve,
                              reference_program)

F64 = torch.float64
FIELDS = ("x", "y", "s", "u", "v", "obj", "res_pri", "res_dua", "res_gap",
          "tau", "kappa")
j_solve = jax.jit(j_solve_conic, static_argnums=(1,))


def jax_program(fields):
    return JConicProgram(**{n: fields[n]
                            for n in JConicProgram.__dataclass_fields__})


def port_mpc():
    p = port_mpc_params()
    return mpc_program(Rocket2D, p, p.x_init, port_config("stock"))


def rel(got, ref):
    got, ref = got.numpy(), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / (1 + np.max(np.abs(ref))))


def assert_close(res, ref, tol):
    for n in FIELDS:
        assert rel(getattr(res, n)[0], ref[n]) <= tol, n


def result_fields(res):
    return {n: np.asarray(getattr(res, n)) for n in res.__dataclass_fields__}


@pytest.mark.parametrize("program", ["mpc", "random_socp"])
def test_plain_douglas_rachford_matches(program):
    """aa_memory=0: 400 plain iterations, 1e-9 relative; the solver asks
    for one SOC projection per iteration."""
    if program == "mpc":
        ref_prog, prog = reference_program("stock"), port_mpc()
    else:
        # the same data in both packages: the reference's program
        ref_prog = program_fields(random_socp(JBuilder, 1, 2))
        prog = convert.conic_program(ref_prog)
    settings = scs.SolverSettings(aa_memory=0)
    ref = result_fields(j_solve(jax_program(ref_prog),
                                JSolverSettings(aa_memory=0)))
    kernels.reset_launches()
    res = scs.solve_conic(prog, settings)
    assert kernels.solver_calls["soc_projection"] == settings.iters
    assert kernels.launches["soc_project"] == 0
    assert_close(res, ref, 1e-9)


def test_anderson_matches_and_warm_resolve():
    """The default (Anderson-accelerated) solve of the MPC program, as the
    reference's mpc_solve makes it with warm_start=True and no warm
    result, to 1e-8; then a warm re-solve from that result at a moved
    x_init. iters + 1 projections per solve (the last plain step)."""
    ref = reference_mpc_solve("scs")
    prog = port_mpc()
    settings = scs.SolverSettings(warm_start=True)
    kernels.reset_launches()
    res = scs.solve_conic(prog, settings)
    assert kernels.solver_calls["soc_projection"] == settings.iters + 1
    assert_close(res, ref, 1e-8)
    assert bool(res.solved[0]) == bool(ref["res_pri"] < 1e-4
                                       and ref["res_dua"] < 1e-4
                                       and ref["res_gap"] < 1e-4)

    # warm re-solve, x_init moved by 1% (the first six rows of b), both
    # packages from the reference's cold result
    moved = dict(reference_program("stock"))
    moved["b"] = moved["b"].copy()
    moved["b"][:6] *= 1.01
    j_warm = JSolverResult(**{n: ref[n]
                              for n in JSolverResult.__dataclass_fields__})
    ref2 = result_fields(j_solve(jax_program(moved),
                                 JSolverSettings(warm_start=True), j_warm))
    prog2 = prog.replace(b=prog.b.clone())
    prog2.b[:, :6] *= 1.01
    kernels.reset_launches()
    res2 = scs.solve_conic(prog2, settings, warm=convert.solver_result(ref))
    assert kernels.solver_calls["soc_projection"] == settings.iters + 1
    assert_close(res2, ref2, 1e-8)


def test_cone_projections_match_reference():
    """project_dual_cone and project_primal_cone on a seeded vector of the
    MPC program's rows: nonneg clamp, SOC blocks, zero cone."""
    prog = port_mpc()
    jprog = jax_program(reference_program("stock"))
    w = np.random.default_rng(2).standard_normal((1, prog.m)) * 3.0
    for j_fn, fn in ((j_dual, scs.project_dual_cone),
                     (j_primal, scs.project_primal_cone)):
        got = fn(torch.tensor(w), prog)
        assert rel(got[0], jax.jit(j_fn)(w[0], jprog)) <= 1e-15
