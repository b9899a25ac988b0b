"""PyTorch port vs the JAX package: the Rocket2D model and the MPC's
exact linear discretization.

Inputs come from a seeded numpy RNG and go through both packages in
float64 on the CPU; agreement is to 1e-12 relative (the two differ only
in summation order, and in the matrix exponential's algorithm:
``torch.linalg.matrix_exp`` against ``jax.scipy.linalg.expm``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scpp_tpu.models import Rocket2D as JRocket2D
from scpp_tpu_torch import convert
from scpp_tpu_torch.models import Rocket2D
from scpp_tpu_torch.models.base import flow_with_jacobians
from scpp_tpu_torch.ops.discretization import exact_linear_discretization
from test_torch_conic import (DISC_SEED, jax_mpc_params, reference_build,
                              seeded_jax_params)

RTOL = 1e-12
N = 16


def rel_err(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300))


def jax_params(seed=None):
    """bench.py's MPC params, or the stock params with seeded bounds and
    physical constants (to exercise every field)."""
    return jax_mpc_params() if seed is None else seeded_jax_params(seed)


def port_params(p, n=1):
    """The reference's params with a scenario axis of n copies."""
    one = convert.params(Rocket2D, {f: getattr(p, f)
                                    for f in p.__dataclass_fields__})
    if n == 1:
        return one
    return one.replace(**{f: getattr(one, f).expand(
        (n,) + getattr(one, f).shape[1:]).contiguous()
        for f in p.__dataclass_fields__ if f != "constrain_initial_final"})


def points(seed):
    """N seeded states and inputs around the landing envelope."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, 6)) * np.array([50, 300, 20, 20, 0.3, 0.2])
    u = np.stack([rng.uniform(-0.3, 0.3, N),
                  rng.uniform(1e4, 4.2e5, N)], axis=1)
    return x, u


@jax.jit
def j_flow_jac(x, u, par):
    f = jax.vmap(JRocket2D.flow_map, (0, 0, None))(x, u, par)
    A, B = jax.vmap(jax.jacfwd(JRocket2D.flow_map, (0, 1)),
                    (0, 0, None))(x, u, par)
    return f, A, B


@pytest.mark.parametrize("seed", [0, 1])
def test_flow_map_and_jacobians_match(seed):
    jp = jax_params(seed)
    x, u = points(seed)
    jpar = JRocket2D.param_vector(jp)
    pp = port_params(jp, N)
    par = Rocket2D.param_vector(pp)
    np.testing.assert_array_equal(par[0].numpy(), np.asarray(jpar))
    got = flow_with_jacobians(Rocket2D, torch.tensor(x), torch.tensor(u),
                              par)
    for g, r in zip(got, j_flow_jac(jnp.asarray(x), jnp.asarray(u), jpar)):
        assert rel_err(g.numpy(), r) <= RTOL


def test_operating_point_init_trajectory_and_clamp():
    jp = jax_params(3)
    pp = port_params(jp)
    for g, r in zip(Rocket2D.operating_point(pp),
                    JRocket2D.operating_point(jp)):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(r), rtol=RTOL,
                                   atol=0)
    for foh in (True, False):
        td = Rocket2D.init_trajectory(pp, 7, foh)
        jtd = JRocket2D.init_trajectory(jp, 7, foh)
        for name in ("X", "U", "t"):
            assert rel_err(getattr(td, name)[0].numpy(),
                           getattr(jtd, name)) <= RTOL
    x, u = points(3)
    u = u * np.array([3.0, 1.5])          # reach past every bound
    got = Rocket2D.clamp_input(port_params(jp, N), torch.tensor(u))
    ref = jax.vmap(JRocket2D.clamp_input, (None, 0))(jp, jnp.asarray(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert Rocket2D.constraint_ref(pp, td) == ()


@pytest.mark.parametrize("seed", [None, DISC_SEED])
def test_exact_linear_discretization_matches(seed):
    """(A, B, z) about the hover point at the stock MPC's dt = 1.5 / 6,
    against the reference's, computed where it builds the stock MPC
    program (test_torch_conic.reference_build)."""
    dt = 1.5 / 6
    ref = reference_build("stock")[seed][1]
    pp = port_params(jax_params(seed))
    x_eq, u_eq = Rocket2D.operating_point(pp)
    got = exact_linear_discretization(Rocket2D, Rocket2D.param_vector(pp),
                                      dt, x_eq, u_eq)
    for g, r in zip(got, ref):
        assert rel_err(g[0].numpy(), r) <= RTOL
