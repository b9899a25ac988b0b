"""Signed block factorization of the staged KKT system, as plain torch
(counterpart of ``scpp_tpu/solver/mono_blocks.py``).

The stage blocks are quasidefinite: M = L S L^T with the signature
S = diag(+1 x p, -1 x (W - p)) (p = w primal columns, then the me dual
ones). The monolithic IPM factors the block-tridiagonal system by cyclic
reduction, as the reference's ``mono_cr_factor`` does: the level loop
is ``staged_kkt.cr_factor`` with :func:`mono_inverse_factor` as its block
inverse factor, and the solve ``staged_kkt.cr_solve``; the CUDA kernel
(csrc/mono_ipm_body.cuh) runs the same order. Each block is factored as
the reference's
``signed_chol_inv`` factors it, in 8-column panels with every pivot
floored: column j takes t_j = max(s_j T_jj, 1e-30) and divides the rows
of its own panel by sqrt(t_j) and the rows below that panel by
L_jj = s_j T_jj / sqrt(t_j) (the panel solve against L_qq). Without a
floored pivot that is the ordinary factor; with one, a pivot of the
wrong sign gives huge factors and the IPM goes on, as the reference's
kernel does. When they overflow (the next pivots square the huge values),
the reference's panel products spread NaN over the block, and so does
this port: a block whose factor is not finite is NaN as a whole.
"""

from __future__ import annotations

import torch

__all__ = ["signed_chol_inv", "mono_inverse_factor"]

PIVOT_FLOOR = 1e-30
PANEL = 8


def _floored_signed_chol(M, p: int, panel: int = PANEL):
    """The reference's panel factorization (``mono_blocks.chol8`` within
    a panel, the panel solve below it) as one column recurrence: L with
    M = L S L^T, every pivot floored at 1e-30."""
    T = M.clone()
    L = torch.zeros_like(M)
    for j in range(M.shape[-1]):
        s = 1.0 if j < p else -1.0
        col = s * T[..., j:, j]
        d = col[..., :1]
        rt = torch.sqrt(torch.clamp_min(d, PIVOT_FLOOR))
        own = (j // panel + 1) * panel - j         # rows left in j's panel
        ell = torch.cat([col[..., :own] / rt, col[..., own:] / (d / rt)], -1)
        L[..., j:, j] = ell
        T[..., j:, j:] -= s * ell[..., :, None] * ell[..., None, :]
    return L


def signed_chol_inv(M, p: int):
    """L and L^{-1} (..., W, W) of the signed factorization M = L S L^T
    of a batch of quasidefinite blocks. LAPACK factors the blocks; the
    few whose pivots fall to the floor (a breakdown) are factored again
    by the floored recurrence, and are NaN if that overflows."""
    W = M.shape[-1]
    L11, info1 = torch.linalg.cholesky_ex(M[..., :p, :p])
    L21 = torch.linalg.solve_triangular(
        L11, M[..., p:, :p].transpose(-1, -2), upper=False).transpose(-1, -2)
    L22, info2 = torch.linalg.cholesky_ex(
        L21 @ L21.transpose(-1, -2) - M[..., p:, p:])
    L = torch.cat([torch.cat([L11, torch.zeros_like(L21.transpose(-1, -2))],
                             dim=-1),
                   torch.cat([L21, L22], dim=-1)], dim=-2)
    piv = torch.diagonal(L, dim1=-2, dim2=-1)
    bad = ((info1 != 0) | (info2 != 0)
           | ~(piv * piv > PIVOT_FLOOR).all(-1))[..., None, None]
    if bool(bad.any()):
        L = torch.where(bad, _floored_signed_chol(M, p), L)
        finite = torch.isfinite(L).all(-1, keepdim=True).all(-2, keepdim=True)
        L = torch.where(finite, L, torch.full_like(L, float("nan")))
    eye = torch.eye(W, dtype=M.dtype, device=M.device).expand_as(L)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


def mono_inverse_factor(M, p: int):
    """L^{-1} of :func:`signed_chol_inv`: the block inverse factor of the
    monolithic IPM's cyclic reduction (``staged_kkt.cr_factor``)."""
    return signed_chol_inv(M, p)[1]
