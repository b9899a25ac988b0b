"""Signed block factorization of the staged KKT system, as plain torch
(counterpart of ``scpp_tpu/solver/mono_blocks.py``).

The stage blocks are quasidefinite: M = L S L^T with the signature
S = diag(+1 x p, -1 x (W - p)) (p = w primal columns, then the me dual
ones). The reference factors the block-tridiagonal system by cyclic
reduction, which existed for the TPU's vector width; this port uses the
sequential stage recursion that the CUDA kernel (csrc/mono_ipm_body.cuh)
runs, which gives the same solution up to rounding:

    D'_0 = D_0,   D'_k = L_k S L_k^T,   P_k = L_k^{-1} O_k^T,
    D'_{k+1} = D_{k+1} - P_k^T S P_k

with O_k = M[k+1, k]. Each block is factored as the reference's
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

__all__ = ["signed_chol_inv", "block_tridiag_factor", "block_tridiag_solve"]

PIVOT_FLOOR = 1e-30
PANEL = 8


def _signature(W: int, p: int, like):
    sig = torch.ones(W, dtype=like.dtype, device=like.device)
    sig[p:] = -1.0
    return sig


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


def block_tridiag_factor(D, O, p: int):
    """D (B, K, W, W) diagonal blocks, O (B, K-1, W, W) sub-diagonal
    blocks (M[k+1, k] = O[k]) -> the per-stage lists (L_k^{-1},
    L_k^{-T} S, P_k, P_k^T S) that :func:`block_tridiag_solve` uses
    (products with S = diag(+-1) are exact, so folding S in changes no
    rounding)."""
    K, W = D.shape[1], D.shape[-1]
    sig = _signature(W, p, D)
    Linvs, Ps = [], []
    Dk = D[:, 0]
    for k in range(K):
        _, Linv = signed_chol_inv(Dk, p)
        Linvs.append(Linv)
        if k + 1 < K:
            Pk = Linv @ O[:, k].transpose(-1, -2)
            Ps.append(Pk)
            Dk = D[:, k + 1] - Pk.transpose(-1, -2) @ (sig[:, None] * Pk)
    Linv = torch.stack(Linvs, 1)
    P = torch.stack(Ps, 1)
    return (Linvs, (Linv.transpose(-1, -2) * sig).unbind(1), Ps,
            (P.transpose(-1, -2) * sig).unbind(1))


def block_tridiag_solve(fact, b, p: int):
    """Solve M x = b for b (B, K, W) with the factor of
    :func:`block_tridiag_factor`:
    t_k = L_k^{-1} v_k, v_{k+1} = b_{k+1} - P_k^T S t_k, then
    x_k = L_k^{-T} S (t_k - P_k x_{k+1}) from the last stage back."""
    Linv, LinvTS, P, PTS = fact
    K = len(Linv)
    bs = b[..., None].unbind(1)
    ts = []
    v = bs[0]
    for k in range(K):
        t = Linv[k] @ v
        ts.append(t)
        if k + 1 < K:
            v = bs[k + 1] - PTS[k] @ t
    x = LinvTS[K - 1] @ ts[K - 1]
    xs = [x]
    for k in range(K - 2, -1, -1):
        x = LinvTS[k] @ (ts[k] - P[k] @ x)
        xs.append(x)
    return torch.stack(xs[::-1], 1)[..., 0]
