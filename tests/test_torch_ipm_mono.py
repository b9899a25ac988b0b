"""PyTorch port vs the JAX package: the monolithic staged IPM.

The port's ``_prep`` -> plain ``_solve_block`` -> ``_post`` against the
reference's ``_prep`` / ``_solve_block`` (under ``jax.jit``, one scenario
per call, so its iteration count is per scenario as the port's is) /
``_post``, on test_ipm_mono's synthetic bounded stage-banded SOCPs
(K=6, w=8, me=8), in float64. The tolerances are test_ipm_mono's. The
plain KKT factor and solve, cyclic reduction as in the reference, are
held to the reference's ``mono_cr_factor`` / ``mono_cr_solve`` to 1e-10.
The kernel itself is held against the same plain version in
test_torch_mono_kernel.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scpp_tpu.solver import ipm_mono as j_mono
from scpp_tpu.solver import mono_blocks as j_blocks
from scpp_tpu.solver.ipm import IPMSettings as JIPMSettings
from scpp_tpu.solver.staged import StagedProgram as JStagedProgram
from scpp_tpu_torch import convert, kernels
from scpp_tpu_torch.solver import (ipm_mono, ipm_staged, mono_blocks,
                                   staged_kkt)
from scpp_tpu_torch.solver.ipm import IPMSettings
from scpp_tpu_torch.solver.ipm_staged import solve_staged_ipm
from test_torch_cr_kernel import qd_blocks
from test_torch_mono_kernel import breakdown_block

K, W, ME, L = 6, 8, 8, 5
SOCS = (3, 4)
MC = L + sum(SOCS)
SET = JIPMSettings(iters=30, eps_reg=1e-8, eps_feas=1e-8, refine_steps=1)
SEEDS = (0, 1, 2)
ARRAYS = ("A_eq", "b_eq", "G", "h", "A_geq", "b_geq", "G_g", "h_g",
          "c_stage", "c_glob")
STRUCT = ("K", "w", "g", "l", "l_g", "soc_sizes", "soc_sizes_g",
          "stage_layout", "glob_layout")


def _random_arrays(seed):
    """test_ipm_mono's bounded, strictly feasible stage-banded SOCP."""
    rng = np.random.default_rng(seed)
    A = 0.5 * rng.standard_normal((K, ME, 2 * W))
    A[-1, :, W:] = 0.0
    G = 0.4 * rng.standard_normal((K, MC, 2 * W))
    G[-1, :, W:] = 0.0
    x0 = rng.standard_normal((K, W))
    xc = np.concatenate(
        [x0, np.concatenate([x0[1:], np.zeros((1, W))], 0)], axis=1)
    b = np.einsum("kmc,kc->km", A, xc)
    s0 = rng.standard_normal((K, MC))
    s0[:, :L] = 1.0 + np.abs(s0[:, :L])
    off = L
    for q in SOCS:
        s0[:, off] = 1.0 + np.sqrt((s0[:, off + 1:off + q] ** 2).sum(-1))
        off += q
    h = np.einsum("kmc,kc->km", G, xc) + s0
    c = 0.3 * rng.standard_normal((K, W))
    return A, b, G, h, c


def jax_program(A, b, G, h, c):
    z = jnp.zeros
    return JStagedProgram(
        A_eq=jnp.asarray(A), b_eq=jnp.asarray(b), G=jnp.asarray(G),
        h=jnp.asarray(h), A_geq=z((0, 0)), b_geq=z((0,)), G_g=z((0, 0)),
        h_g=z((0,)), c_stage=jnp.asarray(c), c_glob=z((0,)),
        K=K, w=W, g=0, l=L, soc_sizes=SOCS, l_g=0, soc_sizes_g=(),
        stage_layout=(("x", 0, W, K),), glob_layout=())


def port_program(progs):
    """The reference's programs stacked on a scenario axis."""
    fields = {n: np.stack([np.asarray(getattr(p, n)) for p in progs])
              for n in ARRAYS}
    fields.update({n: getattr(progs[0], n) for n in STRUCT})
    return convert.staged_program(fields, batched=True)


@functools.lru_cache(maxsize=None)
def _jax_solver():
    statics = (K, W, ME, L, SOCS, SET)

    @jax.jit
    def solve(prog, wx, wy, wz, warm_ok):
        ins, scales = j_mono._prep(prog, SET, wx, wy, wz, warm_ok)
        out = j_mono._solve_block(statics, *[a[None] for a in ins])
        x, y, s, z, diag = (a[0] for a in out)
        return j_mono._post(prog, x, y, s, z, scales), s, diag

    return solve


def jax_solve(prog, warm=None):
    """One scenario through the reference (bsub = 1)."""
    zero = (jnp.zeros((K, W)), jnp.zeros((K, ME)), jnp.zeros((K, MC)))
    wx, wy, wz = zero if warm is None else (warm.x_stage, warm.y_stage,
                                           warm.z_stage)
    return _jax_solver()(prog, wx, wy, wz, jnp.asarray(warm is not None))


def port_solve(prog, warm=None):
    st = convert.ipm_settings(SET)
    B = prog.A_eq.shape[0]
    f = dict(dtype=torch.float64)
    if warm is None:
        wx, wy, wz = (torch.zeros((B, K, W), **f), torch.zeros((B, K, ME), **f),
                      torch.zeros((B, K, MC), **f))
    else:
        wx, wy, wz = warm.x_stage, warm.y_stage, warm.z_stage
    ins, scales = ipm_mono._prep(prog, st, wx, wy, wz,
                                 torch.full((B,), warm is not None))
    out = ipm_mono.mono_solve((K, W, ME, L, SOCS, st), *ins)
    return ipm_mono._post(prog, *out[:4], scales), out[2], out[4], ins


@functools.lru_cache(maxsize=None)
def solved():
    """Cold solves of the three seeds by both packages, then warm
    re-solves on perturbed data (test_ipm_mono's warm-start case), both
    warm-started from the reference's cold results."""
    jprogs = [jax_program(*_random_arrays(s)) for s in SEEDS]
    cold_j = [jax_solve(p) for p in jprogs]
    cold_t = port_solve(port_program(jprogs))
    jprogs2 = [p.replace(h=p.h * 1.01, b_eq=p.b_eq * 0.99) for p in jprogs]
    warm_j = [jax_solve(p, r[0]) for p, r in zip(jprogs2, cold_j)]
    fields = [f for f in cold_j[0][0].__dataclass_fields__]
    warm_in = convert.staged_solver_result(
        {f: np.stack([np.asarray(getattr(r[0], f)) for r in cold_j])
         for f in fields}, batched=True)
    warm_t = port_solve(port_program(jprogs2), warm_in)
    return cold_j, cold_t, warm_j, warm_t


def check_against_reference(ref, got, i):
    (r, s_ref, diag_ref), (g, s_got, diag_got) = ref, (got[0], got[1][i],
                                                      got[2][i])
    np.testing.assert_allclose(float(g.obj[i]), float(r.obj),
                               rtol=1e-7, atol=1e-9)
    for name in ("x_stage", "y_stage", "z_stage"):
        np.testing.assert_allclose(getattr(g, name)[i].numpy(),
                                   np.asarray(getattr(r, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_ref),
                               rtol=1e-4, atol=1e-6)
    # residuals near zero are rounding noise: hold them to 1e-8, an order
    # below test_ipm_mono's quality bar of 1e-7
    for name in ("res_pri", "res_dua", "res_gap"):
        np.testing.assert_allclose(float(getattr(g, name)[i]),
                                   float(getattr(r, name)),
                                   rtol=1e-3, atol=1e-8, err_msg=name)
    it_ref, it_got = float(diag_ref[0, 1]), float(diag_got[0, 1])
    if float(diag_ref[0, 0]) < SET.eps_feas:
        assert it_got == it_ref
    else:
        # Neither run converged: each went on past its best iterate until
        # a Cholesky pivot fell to the 1e-30 floor (both floor it the same
        # way) and the next step was non-finite. Which iteration's nearly
        # singular KKT system breaks down first is decided by rounding:
        # both factor by cyclic reduction in the same order, and the cold
        # seed 1 stops at the reference's iteration, but the warm one
        # stops one iteration earlier (the block inverses still round
        # differently; ROADMAP section 3, item 6). So the count is held
        # to an early stop in both runs; the best iterate is held above.
        assert it_got < SET.iters and it_ref < SET.iters
    np.testing.assert_allclose(float(diag_got[0, 0]), float(diag_ref[0, 0]),
                               rtol=1e-3, atol=1e-12)


@pytest.mark.parametrize("i", range(len(SEEDS)), ids=[f"seed{s}" for s in
                                                      SEEDS])
def test_cold_solve_matches_reference(i):
    cold_j, cold_t, _, _ = solved()
    check_against_reference(cold_j[i], cold_t, i)
    # test_ipm_mono's own quality bar on the converged seeds
    if float(cold_j[i][2][0, 0]) < SET.eps_feas:
        assert float(cold_t[0].res_pri[i]) < 1e-7
        assert float(cold_t[0].res_dua[i]) < 1e-7
        assert float(cold_t[0].res_gap[i]) < 5e-6


@pytest.mark.parametrize("i", range(len(SEEDS)), ids=[f"seed{s}" for s in
                                                      SEEDS])
def test_warm_solve_matches_reference(i):
    _, _, warm_j, warm_t = solved()
    check_against_reference(warm_j[i], warm_t, i)


# The parts held against the reference: its trace and compile cost
# seconds a loop body (its ``iterN`` unrolls N bodies), so ``iter2`` is
# left to the host-built kernel body's test in test_torch_mono_kernel.py,
# against this port's plain ``iter2``; the whole loop is held against
# the reference's by the solve tests above.
PARTS = ("init", "iter1")


@functools.lru_cache(maxsize=None)
def parts_solved():
    """The cold batch of the three seeds prepared by the port's ``_prep``,
    and the reference's ``_solve_block`` at each part of PARTS on those
    inputs, in one compile (a part is static)."""
    prog = port_program([jax_program(*_random_arrays(s)) for s in SEEDS])
    st = convert.ipm_settings(SET)
    B = len(SEEDS)
    f = dict(dtype=torch.float64)
    ins, _ = ipm_mono._prep(
        prog, st, torch.zeros((B, K, W), **f), torch.zeros((B, K, ME), **f),
        torch.zeros((B, K, MC), **f), torch.zeros(B, dtype=torch.bool))
    ref = jax.jit(lambda *a: {p: j_mono._solve_block(
        (K, W, ME, L, SOCS, SET), *a, part=p) for p in PARTS})(
        *[jnp.asarray(t.numpy()) for t in ins])
    return ins, {p: [np.asarray(a) for a in ref[p]] for p in PARTS}


@pytest.mark.parametrize("part", PARTS)
def test_solve_block_part_matches_reference(part):
    """The port's ``part`` hook against the reference's, at this file's
    tolerances. The reference writes N as every scenario's count after
    ``iterN``; the port counts per scenario (ROADMAP section 3, item 7):
    none of these scenarios is done after one iteration, so every count
    is N here (0 after ``init``, whose diag is zero in both)."""
    ins, ref = parts_solved()
    got = ipm_mono.mono_solve((K, W, ME, L, SOCS, convert.ipm_settings(SET)),
                              *ins, part=part)
    for name, a, b in zip("xysz", got[:4], ref[part][:4]):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(got[4][:, 0, 0].numpy(), ref[part][4][:, 0, 0],
                               rtol=1e-3, atol=1e-12)
    np.testing.assert_array_equal(got[4][:, 0, 1].numpy(),
                                  ref[part][4][:, 0, 1])
    if part == "init":
        assert not got[4].any() and not ref[part][4].any()


def test_solve_block_full_part_is_the_whole_solve():
    """Any other part, ``"full"`` or the reference docstring's
    ``"while2"``, is the whole solve that the reference comparisons above
    hold (the plain version and the kernel branch on ``part_code`` only);
    ``iterN`` runs N iterations whatever ``settings.iters`` says."""
    ins, _ = parts_solved()
    st = convert.ipm_settings(SET)
    statics = (K, W, ME, L, SOCS, st)
    whole = ipm_mono._solve_block(statics, *ins)
    got = ipm_mono._solve_block(statics, *ins, part="full")
    assert all(torch.equal(a, b) for a, b in zip(got, whole))
    assert ipm_mono.part_code("while2") == ipm_mono.part_code("full") == -1
    capped = ipm_mono._solve_block((K, W, ME, L, SOCS, st.replace(iters=1)),
                                   *ins, part="iter2")
    two = ipm_mono._solve_block(statics, *ins, part="iter2")
    assert all(torch.equal(a, b) for a, b in zip(capped, two))
    np.testing.assert_array_equal(capped[4][:, 0, 1].numpy(), [2.0] * 3)
    with pytest.raises(ValueError):
        ipm_mono._solve_block(statics, *ins, part="iter-1")


@pytest.mark.parametrize("seed,broken", [
    (5, ()), (7, (7,)), (7, (15,)), (5, (20,)), (5, (12,)), (5, (3, 19))],
    ids=lambda v: str(v) if isinstance(v, int) else
    "cols" + "-".join(map(str, v)) if v else "intact")
def test_signed_factor_floors_pivots_as_reference(seed, broken):
    """The port's block factor against the reference's signed_chol_inv on
    a (w=16, me=8) block whose listed pivots have the wrong sign: the
    pivot floor and the 8-column panels give the same factor where it is
    finite (huge after a floored pivot; columns 7 and 15 have rows below
    their panel), and non-finite blocks alike (12; 3 and 19)."""
    M = breakdown_block(16, 8, broken, seed)
    Lj, Lij = (np.asarray(a)[0] for a in
               jax.jit(j_blocks.signed_chol_inv, static_argnums=1)(
                   jnp.asarray(M[None]), 16))
    Lt, Lit = (a[0].numpy() for a in mono_blocks.signed_chol_inv(
        torch.tensor(M[None]), 16))
    for got, ref in ((Lt, Lj), (Lit, Lij)):
        assert np.isfinite(got).all() == np.isfinite(ref).all()
        if np.isfinite(ref).all():
            np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)
    if broken in ((7,), (15,), (20,)):
        assert np.isfinite(Lt).all() and np.abs(Lt).max() > 1e14


@pytest.mark.parametrize("K", [5, 9])
def test_plain_cr_factor_and_solve_match_reference(K):
    """The monolithic IPM's plain KKT factor (``staged_kkt.cr_factor``'s
    level loop with ``mono_blocks.mono_inverse_factor``) and solve
    (``staged_kkt.cr_solve``) against the reference's ``mono_cr_factor``
    / ``mono_cr_solve`` on two seeded random signed block-tridiagonal
    systems (w=16 primal and 8 dual columns, the reference's 8-column
    panels), level by level and at the root, float64 to 1e-10 relative.
    K=5 reduces 5, 3, 2 blocks, K=9 reduces 9, 5, 3, 2."""
    p, q = 16, 8
    rng = np.random.default_rng(K)
    D, O = qd_blocks(rng, 2, K, p, q)
    b = rng.standard_normal((2, K, p + q))
    levels_j, root_j = jax.jit(j_blocks.mono_cr_factor, static_argnums=2)(
        jnp.asarray(D.numpy()), jnp.asarray(O.numpy()), p)
    x_j = jax.jit(j_blocks.mono_cr_solve, static_argnums=2)(
        (levels_j, root_j), jnp.asarray(b), p)

    def rel(a, ref):
        ref = np.asarray(ref)
        return float(np.abs(a.numpy() - ref).max() / (1 + np.abs(ref).max()))

    fact = staged_kkt.cr_factor(D, O, p,
                                inverse_factor=mono_blocks.mono_inverse_factor)
    levels, root, _ = fact
    assert len(levels) == len(levels_j) == len(
        staged_kkt.level_sizes(K))
    for lv, lv_j in zip(levels, levels_j):
        for a, a_j in zip(lv, lv_j):
            assert rel(a, a_j) <= 1e-10
    assert rel(root, root_j) <= 1e-10
    assert rel(staged_kkt.cr_solve(fact, torch.tensor(b)), x_j) <= 1e-10


def test_cost_scale_median_of_even_count():
    """c_scale is the median of the nonzero |c| entries; with an even
    count the reference averages the two middle values (numpy and JAX do;
    torch.nanmedian returns the lower one)."""
    A, b, G, h, _ = _random_arrays(0)
    c = np.zeros((K, W))
    c[0, :4] = [30.0, -50.0, 70.0, -90.0]
    prog = jax_program(A, b, G, h, c)
    zero = (jnp.zeros((K, W)), jnp.zeros((K, ME)), jnp.zeros((K, MC)))
    ins_j, scales_j = jax.jit(
        lambda p: j_mono._prep(p, SET, *zero, False))(prog)
    _, _, _, ins_t = port_solve(port_program([prog]))
    np.testing.assert_allclose(ins_t[8][0, 0].numpy(), np.asarray(ins_j[8])[0],
                               rtol=1e-12)
    c_st = np.abs(np.asarray(prog.c_stage) * np.asarray(scales_j[0]))
    nz = c_st[c_st > 0]
    assert nz.size % 2 == 0
    lower = float(torch.nanmedian(torch.tensor(nz)))
    assert float(scales_j[3]) == pytest.approx(np.median(nz), rel=1e-12)
    assert float(scales_j[3]) != pytest.approx(lower, rel=1e-6)


def test_nanmedian_rows():
    v = torch.tensor([[1.0, 2.0, 3.0, 4.0, float("nan")],
                      [5.0, float("nan"), 1.0, 3.0, 2.0],
                      [float("nan")] * 5], dtype=torch.float64)
    got = ipm_staged._nanmedian(v)
    np.testing.assert_array_equal(got[:2].numpy(), [2.5, 2.5])
    assert bool(torch.isnan(got[2]))


def test_ipm_settings_match_reference():
    import dataclasses
    ref = {f.name: f.default for f in dataclasses.fields(JIPMSettings)}
    got = {f.name: f.default for f in dataclasses.fields(IPMSettings)}
    assert got == ref
    assert convert.ipm_settings(SET) == IPMSettings(
        iters=30, eps_reg=1e-8, eps_feas=1e-8, refine_steps=1)


def test_mono_supported_and_router():
    prog = port_program([jax_program(*_random_arrays(0))])
    st = convert.ipm_settings(SET)
    assert ipm_mono.mono_supported(prog, st)
    assert not ipm_mono.mono_supported(prog, st.replace(refine_f64=True))
    assert not ipm_mono.mono_supported(prog,
                                       st.replace(kkt_precision="default"))
    # monolith=False, and what the monolith does not take, run the
    # unfused solver, as in the reference; what neither takes raises
    kernels.reset_launches()
    res = solve_staged_ipm(prog, st)                      # monolith=False
    assert float(res.res_pri[0]) < 1e-7
    assert kernels.solver_calls["raw_kkt_solve"] > 0
    with pytest.raises(NotImplementedError, match="refine_f64"):
        solve_staged_ipm(prog, st.replace(monolith=True, refine_f64=True))
    g_prog = prog.replace(g=1, A_geq=torch.zeros((1, 1, 1)),
                          b_geq=torch.zeros((1, 1)),
                          c_glob=torch.zeros((1, 1)))
    assert not ipm_mono.mono_supported(g_prog, st)
    with pytest.raises(NotImplementedError):
        solve_staged_ipm(g_prog, st.replace(monolith=True))
    kernels.reset_launches()
    res = solve_staged_ipm(prog, st.replace(monolith=True))
    assert float(res.res_pri[0]) < 1e-7
    assert kernels.solver_calls["raw_kkt_solve"] == 0


def test_cpu_tensors_take_the_plain_version():
    kernels.reset_launches()
    prog = port_program([jax_program(*_random_arrays(2))])
    port_solve(prog)
    assert kernels.launches["mono_ipm"] == 0


def test_kernel_wrapper_checks_its_inputs():
    """The wrapper refuses what the kernel does not take before it
    builds or launches anything."""
    _, _, _, ins = port_solve(port_program([jax_program(
        *_random_arrays(0))]))
    statics = (K, W, ME, L, SOCS, convert.ipm_settings(SET))
    with pytest.raises(TypeError):
        ipm_mono._mono_cuda(statics, *[t.half() for t in ins])
    with pytest.raises(ValueError, match="shape"):
        ipm_mono._mono_cuda(statics, ins[1], *ins[1:])
    with pytest.raises(ValueError, match="contiguous"):
        ipm_mono._mono_cuda(statics, *ins[:2],
                            ins[2].transpose(1, 2).contiguous()
                            .transpose(1, 2), *ins[3:])
