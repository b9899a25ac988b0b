"""Affine expressions over named optimization variables, batch-first
(counterpart of ``scpp_tpu/solver/affine.py``).

An :class:`Aff` is a vector-valued affine function of the stacked
variable vector, e(x) = sum_v M_v x_v + h, stored as per-variable
coefficient blocks. The structure (which variable, which rows) is static
Python data. A coefficient is either static, a numpy array shared by the
whole batch, or a tensor with the scenario axis in front, where the
coefficients differ per scenario (the dynamics matrices, tan(gamma_gs)
of batched params):

    term  (dim, size) numpy   or   (B, dim, size) tensor
    const (dim,) numpy        or   (B, dim) tensor

A tensor constant or weight is always batched: (B,) is one scalar per
scenario, (B, d) one vector per scenario. Mixing a static block with a
batched one lifts the static block onto the tensor's dtype and device.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch

__all__ = ["Aff", "Var", "concat"]

ArrayLike = Union[np.ndarray, torch.Tensor, float, int]


def _is_static(x) -> bool:
    return isinstance(x, (np.ndarray, float, int, np.floating, np.integer))


def _lift(a, like: torch.Tensor) -> torch.Tensor:
    """A static array as a tensor on ``like``'s dtype and device."""
    return torch.as_tensor(np.asarray(a), dtype=like.dtype, device=like.device)


def _add(a, b):
    """a + b for blocks that are static or batched (broadcasting a static
    block over the batch)."""
    if _is_static(a) and _is_static(b):
        return a + b
    if _is_static(a):
        a = _lift(a, b)
    elif _is_static(b):
        b = _lift(b, a)
    return a + b


def _batched(blocks):
    """Blocks as tensors with one batch axis: static blocks are lifted and
    expanded to the batch of the first tensor among them."""
    like = next(b for b in blocks if not _is_static(b))
    Bn = like.shape[0]
    out = []
    for b in blocks:
        if _is_static(b):
            t = _lift(b, like)
            b = t.expand((Bn,) + t.shape)
        out.append(b)
    return out


class Aff:
    """Vector affine expression: terms[name] @ x[name] summed, plus const."""

    __slots__ = ("dim", "terms", "const")
    __array_priority__ = 1000  # beat numpy broadcasting in mixed ops

    def __init__(self, dim: int, terms: Dict[str, ArrayLike], const: ArrayLike):
        self.dim = int(dim)
        self.terms = terms
        self.const = const

    # ---- constructors ----

    @staticmethod
    def constant(value) -> "Aff":
        """A constant: static (scalar or (d,)), or a batched tensor ((B,)
        a scalar per scenario, (B, d) a vector per scenario)."""
        if _is_static(value):
            v = np.atleast_1d(np.asarray(value, dtype=np.float64))
            return Aff(v.shape[0], {}, v)
        v = value[:, None] if value.dim() == 1 else value
        return Aff(v.shape[1], {}, v)

    @staticmethod
    def _coerce(other, dim) -> "Aff":
        if isinstance(other, Aff):
            return other
        a = Aff.constant(other)
        if a.dim == 1 and dim != 1:
            const = (np.broadcast_to(a.const, (dim,)) if _is_static(a.const)
                     else a.const.expand(a.const.shape[0], dim))
            return Aff(dim, {}, const)
        return a

    # ---- arithmetic ----

    def __add__(self, other) -> "Aff":
        other = Aff._coerce(other, self.dim)
        if other.dim != self.dim:
            if self.dim == 1:
                return other + self
            raise ValueError(f"dim mismatch {self.dim} vs {other.dim}")
        terms = dict(self.terms)
        for k, M in other.terms.items():
            terms[k] = _add(terms[k], M) if k in terms else M
        return Aff(self.dim, terms, _add(self.const, other.const))

    __radd__ = __add__

    def __neg__(self) -> "Aff":
        return Aff(self.dim, {k: -M for k, M in self.terms.items()},
                   -self.const)

    def __sub__(self, other) -> "Aff":
        return self + (-Aff._coerce(other, self.dim))

    def __rsub__(self, other) -> "Aff":
        return (-self) + Aff._coerce(other, self.dim)

    def __mul__(self, w) -> "Aff":
        """Scale by a scalar or elementwise by a (dim,) vector; a tensor
        weight is (B,) (a scalar per scenario) or (B, dim)."""
        if isinstance(w, Aff):
            raise TypeError("Aff*Aff is not convex-affine")
        if _is_static(w):
            wn = np.asarray(w, dtype=np.float64)
            if wn.ndim == 0:
                a = float(wn)
                return Aff(self.dim, {k: a * M for k, M in self.terms.items()},
                           a * self.const)
            if wn.shape != (self.dim,):
                raise ValueError(f"scale shape {wn.shape} vs dim {self.dim}")
            terms = {k: (wn[:, None] * M if _is_static(M)
                         else _lift(wn[:, None], M) * M)
                     for k, M in self.terms.items()}
            const = (wn * self.const if _is_static(self.const)
                     else _lift(wn, self.const) * self.const)
            return Aff(self.dim, terms, const)
        wt = w[:, None] if w.dim() == 1 else w          # (B, 1) or (B, dim)
        if wt.shape[1] not in (1, self.dim):
            raise ValueError(f"scale shape {tuple(w.shape)} vs dim {self.dim}")
        terms = {k: (_lift(M, wt) if _is_static(M) else M) * wt[:, :, None]
                 for k, M in self.terms.items()}
        const = (_lift(self.const, wt) if _is_static(self.const)
                 else self.const) * wt
        return Aff(self.dim, terms, const)

    __rmul__ = __mul__

    def __truediv__(self, w) -> "Aff":
        return self * (1.0 / w)

    def __rmatmul__(self, M) -> "Aff":
        """Constant matrix (p, dim), or batched (B, p, dim), @ aff."""
        if _is_static(M):
            M = np.asarray(M)
            if M.ndim == 1:
                M = M[None, :]

            def mm(X, lead):
                if _is_static(X):
                    return M @ X
                Mt = _lift(M, X)
                return Mt @ X if lead else (Mt @ X[..., None])[..., 0]
        else:
            def mm(X, lead):
                Xt = _lift(X, M) if _is_static(X) else X
                return M @ Xt if lead else (M @ Xt[..., None])[..., 0]
        p = M.shape[-2]
        terms = {k: mm(blk, True) for k, blk in self.terms.items()}
        return Aff(p, terms, mm(self.const, False))

    def sum(self) -> "Aff":
        ones = np.ones((1, self.dim))
        return ones @ self

    def __getitem__(self, key) -> "Aff":
        sel = np.atleast_1d(np.arange(self.dim)[key])
        terms = {k: (M[sel] if _is_static(M) else M[:, sel])
                 for k, M in self.terms.items()}
        const = (np.asarray(self.const)[sel] if _is_static(self.const)
                 else self.const[:, sel])
        return Aff(sel.size, terms, const)

    def __repr__(self):
        return f"Aff(dim={self.dim}, vars={sorted(self.terms)})"


class Var:
    """A named optimization variable with an index grid of a given shape.

    Indexing yields :class:`Aff` selections, e.g. ``X[k]`` (one node, dim n)
    or ``X[:, 4]`` (one state across nodes, dim K).
    """

    __slots__ = ("name", "shape", "size", "_grid")

    def __init__(self, name: str, shape: Tuple[int, ...]):
        self.name = name
        self.shape = tuple(shape)
        self.size = int(np.prod(self.shape)) if self.shape else 1
        self._grid = np.arange(self.size).reshape(self.shape)

    def __getitem__(self, key) -> Aff:
        sel = np.atleast_1d(self._grid[key]).ravel()
        coeff = np.zeros((sel.size, self.size))
        coeff[np.arange(sel.size), sel] = 1.0
        return Aff(sel.size, {self.name: coeff}, np.zeros(sel.size))

    def aff(self) -> Aff:
        """The whole variable, flattened."""
        return self[...]

    def place(self, M, key=...) -> Aff:
        """M @ x[key] as an Aff without materializing a selection product:
        scatter M ((d, k) static or (B, d, k) batched) into this
        variable's coefficient block."""
        sel = np.atleast_1d(self._grid[key]).ravel()
        if _is_static(M):
            M = np.asarray(M)
            if M.ndim == 1:
                M = M[None, :]
            coeff = np.zeros((M.shape[0], self.size))
            coeff[:, sel] = M
        else:
            coeff = M.new_zeros(M.shape[:2] + (self.size,))
            if np.array_equal(sel, np.arange(sel[0], sel[0] + sel.size)):
                # a node's block: a slice, no index copy to the device
                coeff[:, :, sel[0]:sel[0] + sel.size] = M
            else:
                coeff[:, :, torch.as_tensor(sel, device=M.device)] = M
        d = coeff.shape[-2]
        return Aff(d, {self.name: coeff}, np.zeros(d))

    def __repr__(self):
        return f"Var({self.name}, shape={self.shape})"


def concat(affs) -> Aff:
    """Stack affine expressions into one vector expression."""
    affs = [a if isinstance(a, Aff) else Aff.constant(a) for a in affs]
    dim = sum(a.dim for a in affs)
    sizes = {}
    for a in affs:
        for k, M in a.terms.items():
            sizes[k] = M.shape[-1]
    consts = [a.const for a in affs]
    if all(_is_static(c) for c in consts):
        const = np.concatenate([np.atleast_1d(c) for c in consts])
    else:
        const = torch.cat(_batched(consts), dim=1)
    terms = {}
    for name, size in sizes.items():
        blocks = [a.terms.get(name, np.zeros((a.dim, size))) for a in affs]
        if all(_is_static(b) for b in blocks):
            terms[name] = np.concatenate(blocks, axis=0)
        else:
            terms[name] = torch.cat(_batched(blocks), dim=1)
    return Aff(dim, terms, const)
