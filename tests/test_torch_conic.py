"""PyTorch port vs the JAX package: the conic modelling layer (``Aff``,
``Var``, ``ConeProblemBuilder``) on the receding-horizon MPC's programs
and on static programs.

The reference programs and solves that several port test files compare
against are built here once per process (``functools.lru_cache``), as
numpy arrays: each JAX compile of an MPC solve costs seconds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scpp_tpu.algos.mpc import build_mpc_subproblem as j_build_mpc
from scpp_tpu.algos.mpc import mpc_solve as j_mpc_solve
from scpp_tpu.configs.algorithms import MPCConfig as JMPCConfig
from scpp_tpu.models import Rocket2D as JRocket2D
from scpp_tpu.ops.discretization import \
    exact_linear_discretization as j_exact_disc
from scpp_tpu.solver import ConeProblemBuilder as JBuilder
from scpp_tpu.solver.scs import SolverSettings as JSolverSettings
from scpp_tpu_torch import convert
from scpp_tpu_torch.algos.mpc import mpc_program
from scpp_tpu_torch.configs.algorithms import MPCConfig
from scpp_tpu_torch.models import Rocket2D
from scpp_tpu_torch.models.base import batch_params, map_tensors
from scpp_tpu_torch.solver import ConeProblemBuilder
from scpp_tpu_torch.solver.scs import SolverSettings

F64 = torch.float64
# bench.py's MPC state (bench.py:155-157)
X_INIT = (5.0, 30.0, 1.0, -2.0, 0.05, 0.0)
# the stock MPC.info weights, and test_lqr_mpc.py:100-103's
# intermediate-cost configuration
CONFIGS = {
    "stock": {},
    "intermediate": dict(input_weights=(1e-4, 1e-4),
                         state_weights_terminal=(5, 5, 5, 5, 500, 500),
                         intermediate_cost_active=True,
                         state_weights_intermediate=(1, 1, 1, 1, 100, 100)),
}
PROGRAM_FIELDS = ("n_eq", "n_ineq", "soc_sizes", "var_layout")


def jax_mpc_params():
    return JRocket2D.default_params().replace(
        x_init=jnp.asarray(X_INIT), x_final=jnp.zeros(6),
        constrain_initial_final=False)


def port_mpc_params(n=1):
    """The reference's MPC params with a scenario axis of n copies."""
    jp = jax_mpc_params()
    p = convert.params(Rocket2D, {f: getattr(jp, f)
                                  for f in jp.__dataclass_fields__})
    return batch_params(map_tensors(p, lambda t: t[0]), n)


def scenario(p, i):
    """Scenario i of a batched params dataclass, as a batch of one."""
    return map_tensors(p, lambda t: t[i:i + 1])


def program_fields(prog):
    """A reference ConicProgram as numpy arrays and its static layout."""
    out = {n: np.asarray(getattr(prog, n)) for n in ("A", "b", "c")}
    out.update({n: getattr(prog, n) for n in PROGRAM_FIELDS})
    return out


def seeded_jax_params(seed):
    """The stock params with seeded bounds and physical constants (to
    exercise every field of the model)."""
    p = JRocket2D.default_params()
    rng = np.random.default_rng(seed)
    return p.replace(m=p.m * rng.uniform(0.8, 1.2),
                     J_B=p.J_B * rng.uniform(0.8, 1.2),
                     r_T_B=p.r_T_B * rng.uniform(0.8, 1.2),
                     gimbal_max=p.gimbal_max * rng.uniform(0.5, 1.5),
                     T_min=p.T_min * rng.uniform(0.5, 1.5),
                     T_max=p.T_max * rng.uniform(0.8, 1.2))


# the seed of the seeded params whose discretization test_torch_rocket2d
# reads from reference_build
DISC_SEED = 4


@functools.lru_cache(maxsize=None)
def reference_build(name):
    """The reference MPC program of configuration ``name`` and the exact
    linear discretization (A, B, z) it is built on, at X_INIT's params
    (key None) and at seeded_jax_params(DISC_SEED): one compile for
    both."""
    cfg = JMPCConfig(**CONFIGS[name])

    @jax.jit
    def build(p):
        par = JRocket2D.param_vector(p)
        x_eq, u_eq = JRocket2D.operating_point(p)
        A, B, z = j_exact_disc(JRocket2D, par,
                               cfg.time_horizon / (cfg.K - 1), x_eq, u_eq)
        return j_build_mpc(JRocket2D, cfg, A, B, z, p.x_init, p.x_final, p,
                           ()), (A, B, z)

    out = {}
    # the seeded params with the MPC's constrain_initial_final, a static
    # field that the discretization does not read: one compile for both
    seeded = seeded_jax_params(DISC_SEED).replace(
        constrain_initial_final=False)
    for key, p in ((None, jax_mpc_params()), (DISC_SEED, seeded)):
        prog, disc = build(p)
        out[key] = (program_fields(prog), tuple(np.asarray(a) for a in disc))
    return out


def reference_program(name):
    """The reference MPC program of configuration ``name`` at X_INIT."""
    return reference_build(name)[None][0]


@functools.lru_cache(maxsize=None)
def reference_mpc_solve(backend):
    """The reference's ``mpc_solve`` at X_INIT with MPCConfig() ("ipm")
    or MPCConfig(solver=SolverSettings(warm_start=True)) ("scs"): X, U
    and every field of the result, as numpy arrays."""
    cfg = JMPCConfig() if backend == "ipm" else \
        JMPCConfig(solver=JSolverSettings(warm_start=True))
    p = jax_mpc_params()
    X, U, res = j_mpc_solve(JRocket2D, p, p.x_init, cfg)
    out = {n: np.asarray(getattr(res, n))
           for n in res.__dataclass_fields__}
    out.update(X=np.asarray(X), U=np.asarray(U))
    return out


def port_config(name, **changes):
    return MPCConfig(**CONFIGS[name], **changes)


def random_socp(Builder, seed, n_eq, dtype=None):
    """test_solver.py's random strictly feasible SOCP (soc sizes 3, 4),
    built by either package's builder; ``n_eq`` 0 gives one without
    equality rows."""
    rng = np.random.default_rng(seed)
    n, soc_sizes, n_in = 10, [3, 4], 5
    m = n_eq + n_in + sum(soc_sizes)
    A = rng.standard_normal((m, n))

    def interior():
        parts = [np.zeros(n_eq), rng.uniform(0.5, 1.5, n_in)]
        for q in soc_sizes:
            z = rng.standard_normal(q - 1)
            parts.append(np.concatenate([[np.linalg.norm(z)
                                          + rng.uniform(0.5, 1.0)], z]))
        return np.concatenate(parts)

    s0, y0 = interior(), interior()
    y0[:n_eq] = rng.standard_normal(n_eq)
    b = A @ rng.standard_normal(n) + s0
    c = -A.T @ y0

    pb = Builder()
    x = pb.add_variable("x", n)
    if n_eq:
        pb.add_eq(A[:n_eq] @ x[...] - b[:n_eq])
    pb.add_nonneg(b[n_eq:n_eq + n_in] - A[n_eq:n_eq + n_in] @ x[...])
    off = n_eq + n_in
    for q in soc_sizes:
        rows, rhs = A[off:off + q], b[off:off + q]
        pb.add_soc(rhs[0] - rows[0] @ x[...], rows[1:] @ x[...] - rhs[1:])
        off += q
    pb.add_cost(c @ x[...])
    return pb.build(dtype)


def box_lp(Builder, dtype=None):
    """An LP with a box, an equality on a sum, a scaled selection and a
    constant SOC offset: the static paths of Aff and the builder."""
    pb = Builder()
    x = pb.add_variable("x", 2, 3)
    t = pb.add_variable("t")
    pb.add_box(-1.0, x[:, 0], 2.0)
    pb.add_eq(x[0].sum() - 1.0)
    pb.add_eq(np.array([[1.0, 2.0, 3.0]]) @ x[1] - x[0, 2])
    pb.add_soc(t[...] + 0.5, (x[1] - np.array([1.0, 0.0, -1.0]))
               * np.array([2.0, 1.0, 0.5]))
    pb.add_nonneg(x.place(np.eye(3) * 2.0, 1) / 2.0 + 3.0)
    pb.add_cost(t[...] * 2.0 + x[0, 1])
    return pb.build(dtype)


def assert_same_program(got, ref, tol=1e-12):
    for n in PROGRAM_FIELDS:
        assert getattr(got, n) == ref[n], n
    for n in ("A", "b", "c"):
        g, r = getattr(got, n).numpy(), ref[n]
        assert g.shape[1:] == r.shape, n
        assert np.max(np.abs(g - r)) <= tol * (1 + np.max(np.abs(r))), n


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mpc_program_matches_reference(name):
    """A, b, c to 1e-12 and the same cone layout; ``extract`` reads the
    same variables out of a solution vector."""
    ref = reference_program(name)
    p = port_mpc_params()
    prog = mpc_program(Rocket2D, p, p.x_init, port_config(name))
    assert prog.A.dtype == F64 and prog.A.shape[0] == 1
    assert_same_program(prog, ref)
    if name == "stock":
        assert (prog.m, prog.n, prog.n_eq, prog.n_ineq) == (128, 56, 42, 52)
        assert prog.soc_sizes == (7, 13) + (2,) * 7
    x = torch.tensor(np.random.default_rng(0).standard_normal((1, prog.n)))
    for nm, _, shape in prog.var_layout:
        got = prog.extract(x, nm)
        assert got.shape == (1,) + tuple(shape)
        off = dict((v[0], v[1]) for v in ref["var_layout"])[nm]
        size = int(np.prod(shape)) if shape else 1
        np.testing.assert_array_equal(got[0].numpy().ravel(),
                                      x[0, off:off + size].numpy())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_batch_equals_single_builds(name):
    """A batch of three scenarios with different x_init and x_final (the
    dynamics rows and the cost rows differ per scenario) equals three
    single builds."""
    rng = np.random.default_rng(1)
    p = port_mpc_params(3)
    x = p.x_init * torch.tensor(1 + 0.2 * rng.standard_normal((3, 6)))
    xf = torch.tensor(rng.standard_normal((3, 6)))
    p = p.replace(gamma_gs=p.gamma_gs * torch.tensor([1.0, 0.9, 1.1]))
    cfg = port_config(name)
    batch = mpc_program(Rocket2D, p, x, cfg, xf)
    for i in range(3):
        one = mpc_program(Rocket2D, scenario(p, i), x[i:i + 1], cfg,
                          xf[i:i + 1])
        for n in ("A", "b", "c"):
            assert torch.equal(getattr(batch, n)[i], getattr(one, n)[0]), n
    assert not torch.equal(batch.A[0], batch.A[2])


@pytest.mark.parametrize("case", ["socp_eq", "socp_no_eq", "box_lp"])
def test_static_program_matches_reference(case):
    """Programs with static data only (numpy coefficients): one scenario,
    the reference's rows."""
    if case == "box_lp":
        ref, got = box_lp(JBuilder), box_lp(ConeProblemBuilder, F64)
    else:
        n_eq = 2 if case == "socp_eq" else 0
        ref = random_socp(JBuilder, 0, n_eq)
        got = random_socp(ConeProblemBuilder, 0, n_eq, F64)
    assert_same_program(got, program_fields(ref), tol=0.0)


def test_solver_settings_convert():
    s = JSolverSettings(iters=17, warm_start=True, aa_memory=3)
    assert convert.solver_settings(s) == SolverSettings(
        iters=17, warm_start=True, aa_memory=3)
