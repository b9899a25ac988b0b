"""PyTorch port vs the JAX package: the staged SCvx subproblem.

The same seeded trajectory and discretization (numpy arrays) go through
``build_scvx_subproblem_staged`` of both packages at K=5; every tensor of
the StagedProgram must agree to 1e-12 in float64, and the static layout
must be identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scpp_tpu.algos.staged_problems import \
    build_scvx_subproblem_staged as j_build
from scpp_tpu.models import RocketQuat as JRocketQuat
from scpp_tpu.trajectory import DiscretizationData as JDisc
from scpp_tpu_torch import convert
from scpp_tpu_torch.algos.staged_problems import build_scvx_subproblem_staged
from scpp_tpu_torch.models import RocketQuat
from scpp_tpu_torch.solver.staged import NodeExpr, NodeVar, StagedBuilder

K, N_STATE, N_INPUT = 5, 14, 4
TENSORS = ("A_eq", "b_eq", "G", "h", "c_stage")
STATIC = ("K", "w", "g", "l", "soc_sizes", "l_g", "soc_sizes_g",
          "stage_layout", "glob_layout")


@functools.lru_cache(maxsize=None)
def programs(trust, state_trust):
    """(JAX program, port program) for one seeded subproblem."""
    rng = np.random.default_rng(11)
    p = jax.jit(JRocketQuat.nondimensionalize)(JRocketQuat.default_params())
    td = JRocketQuat.init_trajectory(p, K, True)
    td = td.replace(X=td.X * (1 + 1e-2 * rng.standard_normal(td.X.shape)),
                    U=td.U * (1 + 1e-2 * rng.standard_normal(td.U.shape)))
    dd = JDisc(A=jnp.asarray(rng.standard_normal((K - 1, 14, 14))),
               B=jnp.asarray(rng.standard_normal((K - 1, 14, 4))),
               C=jnp.asarray(rng.standard_normal((K - 1, 14, 4))),
               z=jnp.asarray(rng.standard_normal((K - 1, 14))))

    def build(td, dd):
        ref = JRocketQuat.constraint_ref(p, td)
        return j_build(JRocketQuat, p, td, dd, jnp.asarray(trust), 1e3, ref,
                       None if state_trust is None
                       else jnp.asarray(state_trust))

    prog_j = jax.jit(build)(td, dd)
    tp = convert.params(RocketQuat,
                        {f: getattr(p, f) for f in p.__dataclass_fields__})
    ttd = convert.trajectory(td)
    tdd = convert.discretization(dd)
    prog_t = build_scvx_subproblem_staged(
        RocketQuat, tp, ttd, tdd, torch.tensor([trust], dtype=torch.float64),
        1e3, RocketQuat.constraint_ref(tp, ttd),
        None if state_trust is None
        else torch.tensor([state_trust], dtype=torch.float64))
    return prog_j, prog_t


@pytest.mark.parametrize("name", TENSORS)
def test_program_tensors_match(name):
    prog_j, prog_t = programs(5.0, None)
    ref = np.asarray(getattr(prog_j, name))
    got = getattr(prog_t, name)[0].numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_program_layout_matches():
    prog_j, prog_t = programs(5.0, None)
    for name in STATIC:
        assert getattr(prog_t, name) == getattr(prog_j, name), name
    assert prog_t.me == prog_j.me and prog_t.mc == prog_j.mc
    assert prog_t.A_geq.shape == (1, 0, 0) and prog_t.c_glob.shape == (1, 0)


def test_state_trust_region_program_matches():
    prog_j, prog_t = programs(2.0, 0.5)
    for name in TENSORS:
        np.testing.assert_allclose(getattr(prog_t, name)[0].numpy(),
                                   np.asarray(getattr(prog_j, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    assert prog_t.soc_sizes == tuple(prog_j.soc_sizes)


def test_extract_round_trip():
    _, prog_t = programs(5.0, None)
    x = torch.arange(K * prog_t.w, dtype=torch.float64).reshape(1, K, -1)
    X = prog_t.extract((x, torch.zeros(1, 0)), "X")
    U = prog_t.extract((x, torch.zeros(1, 0)), "U")
    nu = prog_t.extract((x, torch.zeros(1, 0)), "nu_abs")
    assert X.shape == (1, K, N_STATE) and U.shape == (1, K, N_INPUT)
    assert nu.shape == (1, K - 1, N_STATE)
    assert float(U[0, 0, 0]) == N_STATE
    with pytest.raises(KeyError):
        prog_t.extract((x, torch.zeros(1, 0)), "sigma")


def test_builder_batches_scenarios():
    """Per-scenario tensor coefficients land in their own scenario's
    rows; static ones are shared by all."""
    sb = StagedBuilder(3)
    x = sb.stage_var("x", 2)
    scale = torch.tensor([1.0, 2.0], dtype=torch.float64)
    offset = torch.tensor([[1.0, 2.0], [3.0, 4.0]], dtype=torch.float64)
    sb.eq(x.sel() * scale - offset, nodes=[0])
    sb.nonneg(x.sel(0) + 1.0)
    sb.soc(scale, x.sel([0, 1]), nodes=[2])
    prog = sb.build(2, torch.float64)
    assert prog.A_eq.shape == (2, 3, 2, 4)
    np.testing.assert_array_equal(prog.A_eq[1, 0, :, :2].numpy(),
                                  2.0 * np.eye(2))
    np.testing.assert_array_equal(prog.b_eq[:, 0].numpy(),
                                  offset.numpy())
    np.testing.assert_array_equal(prog.h[:, :, 0].numpy(), np.ones((2, 3)))
    # SOC head row: t = scale at node 2, padded (1, 0, 0) elsewhere
    np.testing.assert_array_equal(prog.h[:, 2, 1].numpy(), scale.numpy())
    np.testing.assert_array_equal(prog.h[:, 0, 1:].numpy(),
                                  [[1.0, 0.0, 0.0]] * 2)
    with pytest.raises(ValueError):
        sb.eq(NodeVar("x", 2, 3).lin(torch.zeros(2, 2, 1, 2)), nodes=[0, 1, 2])
    with pytest.raises(TypeError):
        NodeExpr(1, {}, np.zeros(1)) * NodeExpr(1, {}, np.zeros(1))
