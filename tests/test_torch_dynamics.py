"""PyTorch port vs the JAX package: integrators, the RocketQuat model and
its Jacobians, multiple shooting (unfused, and the fused path's plain
versions), simulation and the defect costs.

Inputs come from a seeded numpy RNG and go through both packages in
float64 on the CPU; agreement is to ~1e-10 relative (the two differ only
in summation order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scpp_tpu.algos.common import linear_defect_cost as j_linear_cost
from scpp_tpu.algos.common import nonlinear_defect_cost as j_nonlinear_cost
from scpp_tpu.models import RocketQuat as JRocketQuat
from scpp_tpu.models.base import flow_with_jacobians as j_flow_jac
from scpp_tpu.ops.discretization import multiple_shooting as j_shooting
from scpp_tpu.ops.integrators import integrate_fixed as j_integrate
from scpp_tpu.parallel.scenarios import disperse_initial_state as j_disperse
from scpp_tpu_torch import convert
from scpp_tpu_torch.algos.common import (interval_resimulation,
                                         linear_defect_cost,
                                         nonlinear_defect_cost)
from scpp_tpu_torch.models import RocketQuat
from scpp_tpu_torch.models.base import flow_with_jacobians
from scpp_tpu_torch.ops import disc_mono
from scpp_tpu_torch.ops.discretization import multiple_shooting
from scpp_tpu_torch.ops.integrators import integrate_fixed
from scpp_tpu_torch.ops.simulation import simulate
from scpp_tpu_torch.parallel.scenarios import disperse_initial_state

RTOL = 1e-10
F64 = torch.float64
# the RK steps of every reference multiple shooting below, and its
# resimulation, jitted once: each distinct compile costs seconds
SHOOT_SUBSTEPS = 4
j_resim = jax.jit(j_nonlinear_cost, static_argnums=(0, 3, 4))


def rel_err(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300))


@functools.lru_cache(maxsize=None)
def jax_params(nondim=True):
    p = JRocketQuat.default_params()
    return jax.jit(JRocketQuat.nondimensionalize)(p) if nondim else p


def port_params(p):
    """The reference's params with a unit scenario axis."""
    return convert.params(RocketQuat,
                          {f: getattr(p, f) for f in p.__dataclass_fields__})


def perturbed_trajectory(p, K, foh, seed):
    """The model's initial guess with a small seeded perturbation."""
    rng = np.random.default_rng(seed)
    td = jax.jit(lambda q: JRocketQuat.init_trajectory(q, K, foh))(p)
    return td.replace(
        X=td.X * (1 + 1e-3 * rng.standard_normal(td.X.shape)),
        U=td.U * (1 + 1e-3 * rng.standard_normal(td.U.shape)))


@pytest.mark.parametrize("method", ["rk4", "dopri5"])
def test_integrate_fixed_matches(method):
    """A linear time-varying tuple state through both integrators."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((4, 4)) * 0.5
    y0 = rng.standard_normal(4)
    Y0 = rng.standard_normal((4, 3))

    def f_j(y, t):
        return (A @ y[0] * jnp.cos(t), A @ y[1] + t)

    def f_t(y, t):
        At = torch.as_tensor(A)
        return ((At @ y[0][..., None])[..., 0] * torch.cos(t)[:, None],
                At @ y[1] + t[:, None, None])

    ref = j_integrate(f_j, (jnp.asarray(y0), jnp.asarray(Y0)), 0.0, 0.7, 9,
                      method)
    t1 = torch.tensor([0.7], dtype=F64)
    got = integrate_fixed(f_t, (torch.tensor(y0)[None], torch.tensor(Y0)[None]),
                          0.0 * t1, t1, 9, method)
    for r, g in zip(ref, got):
        assert rel_err(g[0], r) < RTOL


def test_flow_map_and_jacobians_match():
    rng = np.random.default_rng(1)
    p = jax_params()
    par = np.asarray(JRocketQuat.param_vector(p))
    X = np.asarray(p.x_init) * (1 + 0.1 * rng.standard_normal((16, 14)))
    U = np.asarray(JRocketQuat.init_trajectory(p, 3, True).U[0]) * (
        1 + 0.3 * rng.standard_normal((16, 4)))
    f_j, A_j, B_j = jax.jit(jax.vmap(
        lambda x, u: j_flow_jac(JRocketQuat, x, u, par)))(
        jnp.asarray(X), jnp.asarray(U))
    parN = torch.tensor(par).expand(16, -1)
    f_t, A_t, B_t = flow_with_jacobians(RocketQuat, torch.tensor(X),
                                        torch.tensor(U), parN)
    assert rel_err(f_t, f_j) < RTOL
    assert rel_err(A_t, A_j) < RTOL
    assert rel_err(B_t, B_j) < RTOL


@pytest.fixture(scope="module")
def foh_shooting():
    """A perturbed K=5 FOH trajectory and the reference's discretization
    of it (one JAX compile, shared by every test of this module)."""
    p = jax_params()
    par = JRocketQuat.param_vector(p)
    td = perturbed_trajectory(p, 5, True, 2)
    return par, td, j_shooting(JRocketQuat, par, td, substeps=SHOOT_SUBSTEPS,
                               variable_time=False)


def test_multiple_shooting_matches(foh_shooting):
    par, td, dd_j = foh_shooting
    dd_t = multiple_shooting(RocketQuat, torch.tensor(np.asarray(par))[None],
                             convert.trajectory(td), substeps=SHOOT_SUBSTEPS)
    for name in ("A", "B", "C", "z"):
        assert rel_err(getattr(dd_t, name)[0], getattr(dd_j, name)) < RTOL


@pytest.mark.parametrize("foh", [True, False], ids=["foh-dopri5", "zoh-rk4"])
def test_fused_plain_discretization_matches(foh_shooting, foh):
    """The fused discretization's plain version (normalized time) against
    the reference's unfused multiple shooting (physical time), the
    reference its own fused kernel is held to (tests/test_disc_mono.py)."""
    if foh:
        par, td, dd_j = foh_shooting
        method = "dopri5"
    else:
        p = jax_params()
        par = JRocketQuat.param_vector(p)
        td = perturbed_trajectory(p, 5, False, 8)
        method = "rk4"
        dd_j = j_shooting(JRocketQuat, par, td, substeps=SHOOT_SUBSTEPS,
                          method=method, variable_time=False)
    tt = convert.trajectory(td)
    got = disc_mono._disc_plain(RocketQuat, tt.X, tt.U, tt.t,
                                torch.tensor(np.asarray(par))[None],
                                SHOOT_SUBSTEPS, method, foh)
    assert (got[2] is None) == (not foh)
    for name, g in zip(("A", "B", "C", "z"), got):
        if g is not None:
            np.testing.assert_allclose(
                g[0].numpy(), np.asarray(getattr(dd_j, name)), rtol=1e-10,
                atol=1e-12, err_msg=name)


def test_fused_plain_resim_matches():
    """The fused resim's plain version on two scenarios (the second
    trajectory scaled by 1 + 1e-3) against the reference's
    nonlinear_defect_cost of each (tests/test_disc_mono.py)."""
    p = jax_params()
    par = JRocketQuat.param_vector(p)
    td = perturbed_trajectory(p, 5, True, 4)
    tds = [td, jax.tree_util.tree_map(lambda a: a * (1.0 + 1e-3), td)]
    ref = [float(j_resim(JRocketQuat, par, t, 8, "dopri5")) for t in tds]
    tt = [convert.trajectory(t) for t in tds]
    par_t = torch.tensor(np.asarray(par))[None].expand(2, -1)
    got = disc_mono._resim_plain(
        RocketQuat, *(torch.cat([getattr(t, f) for t in tt])
                      for f in ("X", "U", "t")), par_t, 8, "dopri5", True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-9)


@pytest.mark.parametrize("foh", [True, False], ids=["foh", "zoh"])
def test_discretization_is_exact_at_its_point(foh):
    """The linearization reproduces the nonlinear propagation at the
    trajectory it was taken around (both hold inputs the same way)."""
    p = RocketQuat.nondimensionalize(port_params(jax_params(nondim=False)))
    par = RocketQuat.param_vector(p)
    td = RocketQuat.init_trajectory(p, 4, foh)
    dd = multiple_shooting(RocketQuat, par, td, substeps=8)
    x = td.X[:, :-1]
    pred = (torch.einsum("bkij,bkj->bki", dd.A, x)
            + torch.einsum("bkij,bkj->bki", dd.B, td.U[:, :3]) + dd.z)
    if foh:
        pred = pred + torch.einsum("bkij,bkj->bki", dd.C, td.U[:, 1:])
    else:
        assert dd.C is None
    sim = interval_resimulation(RocketQuat, par, td, substeps=8)
    assert float((pred - sim).abs().max()) < 1e-12


def test_rk4_discretization_is_exact_at_its_point():
    """The same with the rk4 tableau, against ``simulate`` of every
    interval under the same tableau."""
    p = RocketQuat.nondimensionalize(port_params(jax_params(nondim=False)))
    par = RocketQuat.param_vector(p)
    td = RocketQuat.init_trajectory(p, 4, True)
    dd = multiple_shooting(RocketQuat, par, td, substeps=8, method="rk4")
    pred = (torch.einsum("bkij,bkj->bki", dd.A, td.X[:, :-1])
            + torch.einsum("bkij,bkj->bki", dd.B, td.U[:, :-1])
            + torch.einsum("bkij,bkj->bki", dd.C, td.U[:, 1:]) + dd.z)
    sim = simulate(RocketQuat, par.expand(3, -1), (td.t / 3).expand(3),
                   td.U[0, :-1], td.U[0, 1:], td.X[0, :-1], substeps=8,
                   method="rk4")
    assert float((pred[0] - sim).abs().max()) < 1e-12


def test_defect_costs_match():
    """Nonlinear (resimulated) and linear defect costs of a perturbed
    trajectory around its own discretization."""
    p = jax_params()
    par = JRocketQuat.param_vector(p)
    td0 = perturbed_trajectory(p, 5, True, 3)
    td1 = perturbed_trajectory(p, 5, True, 4)
    dd = j_shooting(JRocketQuat, par, td0, substeps=SHOOT_SUBSTEPS,
                    variable_time=False)
    J_j = j_resim(JRocketQuat, par, td1, 8, "dopri5")
    L_j = jax.jit(j_linear_cost)(td1, dd)
    par_t = torch.tensor(np.asarray(par))[None]
    dd_t = multiple_shooting(RocketQuat, par_t, convert.trajectory(td0),
                             substeps=SHOOT_SUBSTEPS)
    td1_t = convert.trajectory(td1)
    assert rel_err(nonlinear_defect_cost(RocketQuat, par_t, td1_t, 8)[0],
                   J_j) < RTOL
    assert rel_err(linear_defect_cost(td1_t, dd_t)[0], L_j) < RTOL


@pytest.mark.parametrize("name", ["nondimensionalize", "init_trajectory",
                                  "constraint_ref", "scale_trajectory",
                                  "clamp_input"])
def test_model_functions_match(name):
    p_dim = jax_params(nondim=False)
    p = jax_params()
    tpb = port_params(p)
    if name == "nondimensionalize":
        got = RocketQuat.nondimensionalize(port_params(p_dim))
        for f in ("alpha_m", "g_I", "J_B", "r_T_B", "x_init", "x_final",
                  "T_min", "T_max", "t_max", "m_scale", "r_scale"):
            assert rel_err(getattr(got, f)[0], getattr(p, f)) < RTOL, f
        assert tpb.exact_minimum_thrust and not tpb.enable_roll_control
    elif name == "init_trajectory":
        ref = jax.jit(lambda q: JRocketQuat.init_trajectory(q, 7, True))(p)
        got = RocketQuat.init_trajectory(tpb, 7, True)
        for f in ("X", "U", "t"):
            assert rel_err(getattr(got, f)[0], getattr(ref, f)) < RTOL
    elif name == "constraint_ref":
        td = perturbed_trajectory(p, 6, True, 5)
        (ref,) = jax.jit(JRocketQuat.constraint_ref)(p, td)
        (got,) = RocketQuat.constraint_ref(tpb, convert.trajectory(td))
        assert rel_err(got[0], ref) < RTOL
    elif name == "scale_trajectory":
        td = perturbed_trajectory(p, 6, True, 6)
        ref = jax.jit(JRocketQuat.unscale_trajectory)(p, td)
        got = RocketQuat.unscale_trajectory(tpb, convert.trajectory(td))
        assert rel_err(got.X[0], ref.X) < RTOL
        assert rel_err(got.U[0], ref.U) < RTOL
        back = RocketQuat.scale_trajectory(tpb, got)
        assert rel_err(back.X[0], td.X) < RTOL
    else:
        rng = np.random.default_rng(7)
        u = np.asarray(p.T_max) * rng.standard_normal((12, 4))
        ref = jax.jit(jax.vmap(lambda v: JRocketQuat.clamp_input(p, v)))(
            jnp.asarray(u))
        got = RocketQuat.clamp_input(tpb, torch.tensor(u)[None])
        assert rel_err(got[0], ref) < RTOL


def test_dispersion_is_feasible_and_spread():
    """The port draws its own dispersions (torch.Generator); they must be
    the same kind as the reference's: feasible pinned initial states
    (glideslope, tilt and rate cones, w_z = 0) with a similar spread."""
    p = RocketQuat.default_params(F64)
    pb = disperse_initial_state(RocketQuat, p, torch.Generator()
                                .manual_seed(0), 256, 2.0)
    x = pb.x_init
    jp = JRocketQuat.default_params()
    jx = np.asarray(jax.jit(
        lambda k: j_disperse(JRocketQuat, jp, k, 256, 2.0).x_init)(
            jax.random.PRNGKey(0)))
    tan_gs = np.tan(np.deg2rad(30.0))
    assert bool((torch.linalg.vector_norm(x[:, 1:3], dim=1)
                 <= tan_gs * x[:, 3]).all())
    assert bool((torch.linalg.vector_norm(x[:, 11:14], dim=1)
                 <= np.deg2rad(60.0)).all())
    assert bool((x[:, 13] == 0).all())
    q = x[:, 7:11]
    assert torch.allclose(torch.linalg.vector_norm(q, dim=1),
                          torch.ones(256, dtype=x.dtype))
    assert bool((torch.linalg.vector_norm(q[:, 1:3], dim=1)
                 <= np.sqrt(0.5)).all())
    for lo, hi in ((1, 3), (4, 7), (7, 11), (11, 13)):
        s_t = x[:, lo:hi].std(0).numpy()
        s_j = jx[:, lo:hi].std(0)
        np.testing.assert_allclose(s_t, s_j, rtol=0.3)
