"""Quasidefinite block-tridiagonal KKT factorization by cyclic reduction,
batch-first (counterpart of ``scpp_tpu/solver/staged_kkt.py``).

With variables and equality multipliers ordered stage by stage, the
regularized interior-point KKT matrix

    M = [[H + eps I,  A'        ],      H = G' W^-2 G  (conic Gram)
         [A,          -delta I  ]]

is symmetric quasidefinite and block-tridiagonal over the K stages. Each
stage block has the static signature S = diag(+1 x p, -1 x (w - p))
(primal columns, then multiplier columns), so every pivot block factors
as M = L S L' with two Cholesky factors and no pivoting.

Cyclic reduction eliminates the odd-indexed stages level by level
(ceil(log2 K) levels); each level keeps the explicit inverse L^-1 of its
eliminated blocks and the couplings R = L^-1 M[j, j-1], Q = L^-1 M[j, j+1].
A solve is then a down-sweep, a root solve and an up-sweep of block
products. The factor is computed here with library calls; the
single-right-hand-side solve of the IPM runs as a CUDA kernel on the
card (``solver/cr_fused.py``), and :func:`cr_solve` is its plain version.

Layouts: D (B, K, w, w) diagonal blocks, O (B, K-1, w, w) with
M[k+1, k] = O[k]. The arrow border (global variables) and the
sequential ``signed_block_tridiag_*`` factor are not ported.
"""

from __future__ import annotations

import torch

__all__ = ["signed_cholesky", "cr_factor", "cr_solve"]


def _sig(w: int, p: int, like):
    sig = torch.ones(w, dtype=like.dtype, device=like.device)
    sig[p:] = -1.0
    return sig


def _cholesky(M):
    """Lower Cholesky factor of a batch of matrices with JAX's semantics:
    the input is symmetrized first, and a block whose factorization fails
    is NaN on and below its diagonal (``torch.linalg.cholesky`` would
    raise, and sync on the card)."""
    L, info = torch.linalg.cholesky_ex(0.5 * (M + M.transpose(-1, -2)))
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L).tril()


def _tri_solve(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


def signed_cholesky(M, p: int):
    """Factor a batch of quasidefinite blocks M = L S L',
    S = diag(+1 x p, -1 x (w-p)).

    M = [[P, B'], [B, -N]] with P (p x p) SPD and N SPD: L = [[L_P, 0],
    [Bt, L_N]] with P = L_P L_P', Bt = B L_P^{-T}, N + Bt Bt' = L_N L_N'.
    """
    w = M.shape[-1]
    if p == w:
        return _cholesky(M)
    if p == 0:
        return _cholesky(-M)
    L_P = _cholesky(M[..., :p, :p])
    Bt = _tri_solve(L_P, M[..., p:, :p].transpose(-1, -2)).transpose(-1, -2)
    L_N = _cholesky(-M[..., p:, p:] + Bt @ Bt.transpose(-1, -2))
    top = torch.cat([L_P, M.new_zeros(M.shape[:-2] + (p, w - p))], dim=-1)
    return torch.cat([top, torch.cat([Bt, L_N], dim=-1)], dim=-2)


def _inverse_factor(D, p: int):
    L = signed_cholesky(D, p)
    eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device)
    return _tri_solve(L, eye.expand_as(L))


def _sandwich(X, sig, Y):
    """X' S Y for stacked blocks: (..., n, w, a)' x sig x (..., n, w, b)."""
    return (X * sig[:, None]).transpose(-1, -2) @ Y


def cr_factor(D, O, p: int, inverse_factor=_inverse_factor):
    """Cyclic-reduction factorization of the signed block-tridiagonal M.

    D: (B, K, w, w), O: (B, K-1, w, w). Returns ``(levels, Linv_root, p)``
    with one ``(Linv, R, Q)`` per level, each (B, n_odd, w, w), and the
    root's inverse factor (B, w, w). The level sizes are static functions
    of K (:func:`level_sizes`). ``inverse_factor(M, p)`` gives L^{-1} of
    a batch of blocks M = L S L'; the monolithic IPM passes the pivot-
    floored ``mono_blocks.signed_chol_inv``, which makes this the
    reference's ``mono_cr_factor``."""
    Bn, w = D.shape[0], D.shape[-1]
    sig = _sig(w, p, D)
    levels = []
    n = D.shape[1]
    while n > 1:
        n_odd = n // 2
        n_even = n - n_odd
        # pad the super-diagonal so the last odd stage (when n is even)
        # sees a zero right coupling
        O_pad = torch.cat([O, D.new_zeros((Bn, 1, w, w))], dim=1)[:, :2 * n_odd]
        O_left = O_pad[:, 0::2]                  # M[j, j-1], j = 2m+1
        O_rt = O_pad[:, 1::2]                    # M[j+1, j] -> M[j, j+1]'
        Linv = inverse_factor(D[:, 1::2], p)
        R = Linv @ O_left
        Q = Linv @ O_rt.transpose(-1, -2)

        D_even = D[:, 0::2].clone()
        D_even[:, :n_odd] -= _sandwich(R, sig, R)
        D_even[:, 1:] -= _sandwich(Q, sig, Q)[:, :n_even - 1]
        O_even = -_sandwich(Q, sig, R)[:, :n_even - 1]

        levels.append((Linv, R, Q))
        D, O, n = D_even, O_even, n_even
    return tuple(levels), inverse_factor(D[:, 0], p), p


def level_sizes(K: int):
    """[(n_blocks, n_odd), ...] of each level until one block is left."""
    sizes = []
    n = K
    while n > 1:
        sizes.append((n, n // 2))
        n -= n // 2
    return sizes


def cr_solve(fact, b):
    """Solve M x = b given :func:`cr_factor`; b: (B, K, w) or
    (B, K, w, r)."""
    levels, Linv_root, p = fact
    w = Linv_root.shape[-1]
    sig = _sig(w, p, Linv_root)
    squeeze = b.dim() == 3
    if squeeze:
        b = b[..., None]
    sig_col = sig[:, None]

    # down-sweep: eliminate odd rhs level by level
    ts = []
    for Linv, R, Q in levels:
        n = b.shape[1]
        n_odd = n // 2
        n_even = n - n_odd
        t = Linv @ b[:, 1::2]
        st = sig_col * t
        b_even = b[:, 0::2].clone()
        b_even[:, :n_odd] -= R.transpose(-1, -2) @ st
        b_even[:, 1:] -= (Q.transpose(-1, -2) @ st)[:, :n_even - 1]
        ts.append(t)
        b = b_even

    # root
    u = Linv_root[:, None] @ b
    x = Linv_root[:, None].transpose(-1, -2) @ (sig_col * u)

    # up-sweep: recover odd unknowns
    for (Linv, R, Q), t in zip(reversed(levels), reversed(ts)):
        n_even, n_odd = x.shape[1], t.shape[1]
        x_pad = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
        rhs = t - R @ x[:, :n_odd] - Q @ x_pad[:, 1:n_odd + 1]
        x_odd = Linv.transpose(-1, -2) @ (sig_col * rhs)
        full = x.new_empty((x.shape[0], n_even + n_odd) + x.shape[2:])
        full[:, 0::2] = x
        full[:, 1::2] = x_odd
        x = full

    return x[..., 0] if squeeze else x
