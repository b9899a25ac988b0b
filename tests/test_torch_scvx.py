"""PyTorch port vs the JAX package: the batch-first SCvx driver.

Two SCvx steps of a batch of two dispersed RocketQuat K=8 scenarios at
the flagship solver settings, in float64: the port's subproblem,
monolithic solve, defect costs and accept / trust-region decisions
against the reference's pieces, each jitted at K=8 (the JAX
``solve_scvx`` itself is never compiled here). The reference's pieces
take the port's discretization as input: multiple shooting is held
against the reference in test_torch_dynamics, and tracing the
reference's shooting once more would cost ~10 s of the suite's budget. The accept/reject cascade
of a whole run is chaotic, so full runs are held by convergence and the
defect-cost basin, not by trajectories: the port's own float64 run of
test_golden_prod_tolerance's configuration (K=30) must converge into
0 < J_end < 0.06.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scpp_tpu.algos.common import linear_defect_cost as j_linear_cost
from scpp_tpu.algos.common import nonlinear_defect_cost as j_nonlinear_cost
from scpp_tpu.algos.staged_problems import \
    build_scvx_subproblem_staged as j_build
from scpp_tpu.models import RocketQuat as JRocketQuat
from scpp_tpu.parallel.scenarios import disperse_initial_state as j_disperse
from scpp_tpu.solver import ipm_mono as j_mono
from scpp_tpu.solver.ipm import IPMSettings as JIPMSettings
from scpp_tpu.trajectory import DiscretizationData as JDisc
from scpp_tpu_torch import convert
from scpp_tpu_torch.algos.common import linear_defect_cost, \
    nonlinear_defect_cost
from scpp_tpu_torch.algos.scvx import solve_scvx
from scpp_tpu_torch.algos.staged_problems import build_scvx_subproblem_staged
from scpp_tpu_torch.configs.algorithms import SCvxConfig
from scpp_tpu_torch.models import RocketQuat
from scpp_tpu_torch.models.base import batch_params
from scpp_tpu_torch.ops.discretization import multiple_shooting
from scpp_tpu_torch.parallel.scenarios import bench_initial_states
from scpp_tpu_torch.solver.ipm import IPMSettings
from scpp_tpu_torch.solver.ipm_staged import solve_staged_ipm

K, B = 8, 2
J_SET = JIPMSettings(iters=10, eps_reg=1e-4, eps_feas=1e-4, refine_steps=0,
                     monolith=True)
CFG = SCvxConfig(K=K, max_iterations=30, solve_budget=2,
                 change_threshold=1e-3, nondimensionalize=True, substeps=6,
                 sim_substeps=8, solver=convert.ipm_settings(J_SET))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel_err(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300))


@functools.lru_cache(maxsize=None)
def jax_start():
    """Dispersed dimensional params, their nondimensional form and the
    initial trajectories and refs of the batch (reference side)."""
    @jax.jit
    def start(key):
        pb = j_disperse(JRocketQuat, JRocketQuat.default_params(), key, B,
                        2.0)
        pn = jax.vmap(JRocketQuat.nondimensionalize)(pb)
        td = jax.vmap(lambda p: JRocketQuat.init_trajectory(p, K, True))(pn)
        return pb, pn, td, jax.vmap(JRocketQuat.constraint_ref)(pn, td)

    return start(jax.random.PRNGKey(3))


def per_scenario(fn, *trees):
    """Run a jitted one-scenario reference function on each scenario of a
    batch and stack the results (one compile, B calls)."""
    outs = [fn(*[jax.tree_util.tree_map(lambda a: a[i], t) for t in trees])
            for i in range(B)]
    return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *outs)


@functools.lru_cache(maxsize=None)
def j_fns():
    def build(p, td, dd, trust, ref):
        return j_build(JRocketQuat, p, td, dd, trust, 1e3, ref)

    def prep(prog, wx, wy, wz, warm_ok):
        return j_mono._prep(prog, J_SET, wx, wy, wz, warm_ok)

    def solve(*ins):
        statics = (K, 32, 16, 30, (5, 3, 3, 4, 4, 3), J_SET)
        return tuple(a[0] for a in j_mono._solve_block(
            statics, *[a[None] for a in ins]))

    def costs(p, prog, res, dd, td):
        new = td.replace(X=prog.extract(res.x, "X"),
                         U=prog.extract(res.x, "U"))
        return (new, j_linear_cost(new, dd),
                j_nonlinear_cost(JRocketQuat, JRocketQuat.param_vector(p),
                                 new, 8))

    return (jax.jit(build), jax.jit(prep), jax.jit(solve),
            jax.jit(j_mono._post), jax.jit(costs))


@functools.lru_cache(maxsize=None)
def jax_dd(n):
    """The port's discretization at the reference's step-n trajectory,
    as the reference's DiscretizationData."""
    tp = port_start()[0]
    td = jax_start()[2] if n == 1 else jax_step(1)[8]
    dd = multiple_shooting(RocketQuat, RocketQuat.param_vector(tp),
                           convert.trajectory(td, batched=True), substeps=6)
    return JDisc(A=jnp.asarray(dd.A.numpy()), B=jnp.asarray(dd.B.numpy()),
                 C=jnp.asarray(dd.C.numpy()), z=jnp.asarray(dd.z.numpy()))


@functools.lru_cache(maxsize=None)
def jax_prog(n):
    _, pn, td0, ref = jax_start()
    td, trust = (td0, jnp.full((B,), 5.0)) if n == 1 else (
        jax_step(1)[8], jnp.asarray(jax_step(1)[9]))
    return per_scenario(j_fns()[0], pn, td, jax_dd(n), trust, ref)


@functools.lru_cache(maxsize=None)
def jax_solve(n):
    _, prep, solve, post, _ = j_fns()
    prog = jax_prog(n)
    if n == 1:
        warm = (jnp.zeros((B, K, 32)), jnp.zeros((B, K, 16)),
                jnp.zeros((B, K, 52)), jnp.zeros((B,), bool))
    else:
        res = jax_solve(1)[0]
        warm = (res.x_stage, res.y_stage, res.z_stage, jnp.ones((B,), bool))
    ins, scales = per_scenario(prep, prog, *warm)
    x, y, s, z, diag = per_scenario(solve, *ins)
    return per_scenario(post, prog, x, y, s, z, scales), diag


@functools.lru_cache(maxsize=None)
def jax_step(n):
    """The reference's state after SCvx step n (1 or 2): (td, dd, prog,
    result, diag, L, J, accept, td_next, trust_next, last_J)."""
    _, pn, td0, _ = jax_start()
    if n == 1:
        td, trust, last_J = td0, np.full(B, 5.0), None
    else:
        prev = jax_step(1)
        td, trust, last_J = prev[8], prev[9], prev[10]
    dd, prog = jax_dd(n), jax_prog(n)
    res, diag = jax_solve(n)
    new, L, J = per_scenario(j_fns()[4], pn, prog, res, dd, td)
    accept, trust_next = scvx_decision(last_J, np.asarray(L), np.asarray(J),
                                       trust)
    td_next = jax.tree_util.tree_map(
        lambda a, b: jnp.where(accept.reshape((B,) + (1,) * (a.ndim - 1)),
                               a, b), new, td)
    return (td, dd, prog, res, diag, L, J, accept, td_next, trust_next,
            np.asarray(J))


def scvx_decision(last_J, L, J, trust):
    """The reference's accept / trust-region update of one step
    (scpp_tpu/algos/scvx.py), for finite steps, in numpy."""
    if last_J is None:
        return np.ones(B, bool), trust
    predicted = last_J - L
    rho = (last_J - J) / np.where(np.abs(predicted) < 1e-30, 1e-30,
                                  predicted)
    conv = np.abs(predicted) < CFG.change_threshold
    step_ok = predicted > -CFG.change_threshold
    reject = (~conv & (rho < CFG.rho_0)) | ~step_ok
    accept = ~reject
    shrink = reject | (accept & (rho < CFG.rho_1))
    grow = accept & (rho >= CFG.rho_2)
    trust_new = np.where(shrink, trust / CFG.alpha,
                         np.where(grow, trust * CFG.beta, trust))
    return accept, np.where(conv & step_ok, trust, trust_new)


@functools.lru_cache(maxsize=None)
def port_start():
    """The port's nondimensional params, trajectories and refs, on the
    reference's dispersed params."""
    pn = jax_start()[1]
    tp = convert.params(RocketQuat, {f: getattr(pn, f)
                                     for f in pn.__dataclass_fields__},
                        batched=True)
    td = RocketQuat.init_trajectory(tp, K, True)
    return tp, td, RocketQuat.constraint_ref(tp, td)


@functools.lru_cache(maxsize=None)
def port_dd():
    tp, td, _ = port_start()
    return multiple_shooting(RocketQuat, RocketQuat.param_vector(tp), td,
                             substeps=6)


@functools.lru_cache(maxsize=None)
def port_prog():
    tp, td, ref = port_start()
    return build_scvx_subproblem_staged(
        RocketQuat, tp, td, port_dd(), torch.full((B,), 5.0,
                                                  dtype=torch.float64),
        1e3, ref)


@functools.lru_cache(maxsize=None)
def port_solve():
    return solve_staged_ipm(port_prog(), CFG.solver)


@functools.lru_cache(maxsize=None)
def port_runs(budget):
    pb, _, _, _ = jax_start()
    tp = convert.params(RocketQuat, {f: getattr(pb, f)
                                     for f in pb.__dataclass_fields__},
                        batched=True)
    return solve_scvx(RocketQuat, tp,
                      dataclasses.replace(CFG, solve_budget=budget),
                      device="cpu")


def test_dispersed_start_matches():
    _, pn, td_j, ref_j = jax_start()
    tp, td_t, ref_t = port_start()
    assert rel_err(tp.x_init, pn.x_init) < 1e-12
    for name in ("X", "U", "t"):
        assert rel_err(getattr(td_t, name), getattr(td_j, name)) < 1e-12
    assert rel_err(ref_t[0], ref_j[0]) < 1e-12


def test_step_program_matches():
    prog_j = jax_prog(1)
    prog_t = port_prog()
    for name in ("A_eq", "b_eq", "G", "h", "c_stage"):
        # the discretization enters at ~1e-13, the rest is exact
        assert rel_err(getattr(prog_t, name), getattr(prog_j, name)) < 1e-12
    assert prog_t.soc_sizes == tuple(prog_j.soc_sizes)


def test_step_solve_matches():
    res_j, _ = jax_solve(1)
    res_t = port_solve()
    np.testing.assert_allclose(res_t.obj.numpy(), np.asarray(res_j.obj),
                               rtol=1e-7)
    np.testing.assert_allclose(res_t.x_stage.numpy(),
                               np.asarray(res_j.x_stage), rtol=1e-4,
                               atol=1e-6)
    for name in ("res_pri", "res_dua"):
        np.testing.assert_allclose(getattr(res_t, name).numpy(),
                                   np.asarray(getattr(res_j, name)),
                                   rtol=1e-3, atol=1e-8)


def test_step_costs_match():
    _, _, _, _, _, L_j, J_j, *_ = jax_step(1)
    tp, td, _ = port_start()
    prog, res = port_prog(), port_solve()
    new = td.replace(X=prog.extract(res.x, "X"), U=prog.extract(res.x, "U"))
    L_t = linear_defect_cost(new, port_dd())
    J_t = nonlinear_defect_cost(RocketQuat, RocketQuat.param_vector(tp), new,
                                8)
    np.testing.assert_allclose(L_t.numpy(), np.asarray(L_j), rtol=1e-6)
    np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j), rtol=1e-6)


@pytest.mark.parametrize("n", [1, 2])
def test_driver_steps_match(n):
    """solve_scvx's history after n steps: the costs, the accept decision
    and the trust radius of the reference's step n."""
    *_, L_j, J_j, accept_j, td_j, trust_j, _ = jax_step(n)
    run = port_runs(2)
    np.testing.assert_allclose(run.linear_cost[:, n - 1].numpy(),
                               np.asarray(L_j), rtol=1e-6)
    np.testing.assert_allclose(run.nonlinear_cost[:, n - 1].numpy(),
                               np.asarray(J_j), rtol=1e-6)
    np.testing.assert_array_equal(run.accepted[:, n - 1].numpy(), accept_j)
    np.testing.assert_allclose(run.all_X[:, n - 1].numpy(),
                               np.asarray(td_j.X), rtol=1e-6, atol=1e-8)
    if n == 2:
        np.testing.assert_allclose(run.trust_region.numpy(), trust_j,
                                   rtol=1e-12)
        td_dim = jax.vmap(JRocketQuat.unscale_trajectory)(jax_start()[1],
                                                          td_j)
        np.testing.assert_allclose(run.td.X.numpy(), np.asarray(td_dim.X),
                                   rtol=1e-6, atol=1e-6)
        assert run.steps.tolist() == [2] * B
        assert run.all_X.shape == (B, 2, K, 14)


def test_history_back_fills_past_the_last_step():
    run = port_runs(2)
    longer = solve_scvx(RocketQuat, convert.params(
        RocketQuat, {f: getattr(jax_start()[0], f)
                     for f in jax_start()[0].__dataclass_fields__},
        batched=True), dataclasses.replace(CFG, solve_budget=2,
                                           max_iterations=1), device="cpu")
    # max_iterations=1: every scenario is done after its first accepted
    # step, so slot 1 repeats slot 0 and is not counted as accepted
    assert longer.steps.tolist() == [1] * B
    assert bool((longer.nonlinear_cost[:, 1] == longer.nonlinear_cost[:, 0])
                .all())
    assert not bool(longer.accepted[:, 1].any())
    np.testing.assert_array_equal(longer.nonlinear_cost[:, 0].numpy(),
                                  run.nonlinear_cost[:, 0].numpy())


@pytest.mark.parametrize("change", [{"backend": "dense"},
                                    {"l1_split": False},
                                    {"solver": IPMSettings(kkt="banded")}])
def test_unported_configurations_raise(change):
    p = RocketQuat.default_params(torch.float64)
    with pytest.raises(NotImplementedError):
        solve_scvx(RocketQuat, p, dataclasses.replace(CFG, **change),
                   device="cpu")


def bench_x_init():
    """The initial states of the 64 scenarios that bench.py solves
    (bench.py:bench_throughput): ``disperse_initial_state(RocketQuat,
    RocketQuat.default_params(), PRNGKey(0), 64, scale=2.0)`` in float32,
    as bench.py runs without x64 (jitted here: one compile instead of
    ~5 s of per-operation dispatch; the two differ by at most 6e-8)."""
    with jax.enable_x64(False):
        fn = jax.jit(lambda key: j_disperse(
            JRocketQuat, JRocketQuat.default_params(), key, 64, 2.0).x_init)
        return np.asarray(fn(jax.random.PRNGKey(0)))


def test_bench_initial_states_are_bench_py_s():
    """The committed x_init file that chip_smoke.py solves holds exactly
    bench.py's 64 dispersed initial states."""
    want = bench_x_init()
    assert want.dtype == np.float32 and want.shape == (64, 14)
    got = bench_initial_states()
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import pkgutil, sys, importlib, scpp_tpu_torch\n"
        "for m in pkgutil.walk_packages(scpp_tpu_torch.__path__, "
        "'scpp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'scpp_tpu')]\n"
        "print(sum(m.startswith('scpp_tpu_torch') for m in sys.modules))\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[-1]) >= 20


@pytest.mark.slow
def test_golden_prod_tolerance_run():
    """The port's own float64 SCvx run at test_golden_prod_tolerance's
    configuration (the rocketquat_scvx golden's SCvxConfig with the staged
    backend, split L1 and the production IPM settings, monolithic)."""
    cfg = SCvxConfig(
        K=30, max_iterations=30, solve_budget=45, change_threshold=1e-3,
        nondimensionalize=True, substeps=6, sim_substeps=8,
        backend="staged", l1_split=True,
        solver=IPMSettings(iters=25, eps_reg=1e-4, eps_feas=1e-5,
                           refine_steps=2, monolith=True))
    p = batch_params(RocketQuat.default_params(torch.float64), 1)
    res = solve_scvx(RocketQuat, p, cfg, device="cpu")
    assert bool(res.converged[0])
    J_end = float(res.nonlinear_cost[0, -1])
    assert 0.0 < J_end < 0.06, J_end
    golden = np.load(os.path.join(REPO, "tests", "goldens",
                                  "rocketquat_scvx.npz"))
    assert res.td.X.shape[1:] == golden["X"].shape
