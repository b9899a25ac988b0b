"""PyTorch port vs the JAX package: the cyclic-reduction KKT factor and
solve (``solver/staged_kkt.py``).

``signed_cholesky``, ``cr_factor`` and ``cr_solve`` against the
reference's (jitted, one compile per shape) on random quasidefinite
block-tridiagonal systems in float64, single- and multi-right-hand-side,
to 1e-10 relative; and the reference's Cholesky semantics on a block
that is not quasidefinite: NaN in that block only. The CUDA kernel that
replaces ``cr_solve`` on the card is held against the port's
``cr_solve`` in test_torch_cr_kernel.py, and here, with that plain
version, against the TPU kernel it replaces (``cr_pallas``, in
interpret mode).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scpp_tpu.solver import cr_pallas as j_crp
from scpp_tpu.solver import staged_kkt as j_kkt
from scpp_tpu_torch.solver import cr_fused, staged_kkt
from test_torch_cr_kernel import host_lib, host_solve, qd_blocks  # noqa: F401

SHAPES = [(1, 3, 2), (4, 3, 2), (7, 5, 3), (8, 6, 3)]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (1.0 + np.max(np.abs(b))))


@functools.lru_cache(maxsize=None)
def _jax_ref(p):
    @jax.jit
    def ref(D, O, b, b_multi):
        with jax.default_matmul_precision("highest"):
            fact = j_kkt.cr_factor(D, O, p)
            return (jax.vmap(lambda M: j_kkt.signed_cholesky(M, p))(D), fact,
                    j_kkt.cr_solve(fact, b), j_kkt.cr_solve(fact, b_multi))
    return ref


@pytest.mark.parametrize("K,p,q", SHAPES, ids=[f"K{k}-p{p}-q{q}"
                                               for k, p, q in SHAPES])
def test_factor_and_solve_match(K, p, q):
    rng = np.random.default_rng(10 * K + p)
    D, O = qd_blocks(rng, 1, K, p, q)
    b = rng.standard_normal((K, p + q))
    b_multi = rng.standard_normal((K, p + q, 3))
    L_j, (levels_j, root_j, _), x_j, xm_j = _jax_ref(p)(
        D[0].numpy(), O[0].numpy(), b, b_multi)

    assert rel(staged_kkt.signed_cholesky(D[0], p), L_j) <= 1e-10
    fact = staged_kkt.cr_factor(D, O, p)
    levels, root, p_out = fact
    assert p_out == p and len(levels) == len(levels_j)
    for lv, lv_j in zip(levels, levels_j):
        for a, a_j in zip(lv, lv_j):
            assert rel(a[0], a_j) <= 1e-10
    assert rel(root[0], root_j) <= 1e-10
    assert rel(staged_kkt.cr_solve(fact, torch.tensor(b)[None])[0],
               x_j) <= 1e-10
    assert rel(staged_kkt.cr_solve(fact, torch.tensor(b_multi)[None])[0],
               xm_j) <= 1e-10


@pytest.mark.parametrize("part", ["primal", "dual"])
def test_indefinite_block_is_nan_as_in_jax(part):
    """A batch of four stage blocks in which block 2 is not quasidefinite
    (its primal part, or its negated dual Schur complement, indefinite):
    JAX's Cholesky returns NaN for a failed factor, so the reference's
    signed factor of that block is NaN and the others are untouched. The
    port does the same (torch.linalg.cholesky would raise)."""
    p = 3
    D, _ = qd_blocks(np.random.default_rng(4), 1, 4, p, 2)
    D = D[0].clone()
    if part == "primal":
        D[2, 0, 0] = -50.0
    else:
        D[2, p:, p:] = 50.0 * torch.eye(2, dtype=D.dtype)
    L_j = np.asarray(jax.jit(jax.vmap(
        lambda M: j_kkt.signed_cholesky(M, p)))(D.numpy()))
    L = staged_kkt.signed_cholesky(D, p).numpy()
    np.testing.assert_array_equal(np.isnan(L), np.isnan(L_j))
    bad = np.isnan(L).any(axis=(1, 2))
    assert bad.tolist() == [False, False, True, False]
    # a failed Cholesky factor is NaN on and below its diagonal
    if part == "primal":
        assert np.isnan(L[2][np.tril_indices(5)]).all()
    else:
        # the primal factor stands; the dual Schur factor is NaN
        assert np.isfinite(L[2, :, :p]).all()
        assert np.isnan(L[2, p:, p:][np.tril_indices(2)]).all()
    assert np.isfinite(L[~bad]).all()
    assert rel(L[~bad], L_j[~bad]) <= 1e-10


PALLAS_SHAPES = [(4, 3, 2), (8, 4, 2)]


@pytest.mark.parametrize("K,p,q", PALLAS_SHAPES, ids=[
    f"K{k}-p{p}-q{q}" for k, p, q in PALLAS_SHAPES])
def test_port_solve_matches_the_pallas_kernel(host_lib, K, p, q):
    """The port's single-right-hand-side solve against the TPU kernel it
    replaces, ``cr_pallas.cr_solve_fused`` in interpret mode, on the same
    packed factor of two scenarios: the plain version (what
    ``cr_fused.cr_solve_single`` runs for CPU tensors) and the kernel
    body built for the host (the full ring, and one slot), float64, to
    1e-10 relative. The reference packs each scenario's factor into its
    own lane-packed planes from the port's blocks."""
    rng = np.random.default_rng(100 + K)
    D, O = qd_blocks(rng, 2, K, p, q)
    b = rng.standard_normal((2, K, p + q))
    packed = cr_fused.cr_pack(staged_kkt.cr_factor(D, O, p))
    bt = torch.tensor(b)
    plain = cr_fused.cr_solve_single(packed, bt)
    body = host_solve(host_lib, packed, bt, 32)
    body1 = host_solve(host_lib, packed, bt, 32, slots=1)
    levels, root, _ = cr_fused.cr_unpack(packed)
    for s in range(2):
        fact_j = (tuple(tuple(jnp.asarray(a[s].numpy()) for a in lv)
                        for lv in levels), jnp.asarray(root[s].numpy()), p)
        packed_j, p_j = j_crp.cr_pack(fact_j, K)
        with jax.default_matmul_precision("highest"):
            x_j = np.asarray(j_crp.cr_solve_fused(
                packed_j, jnp.asarray(b[s]), p_j, interpret=True))
        for x in (plain, body, body1):
            assert rel(x[s], x_j) <= 1e-10
