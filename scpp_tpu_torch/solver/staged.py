"""Stage-structured conic programs, batch-first (counterpart of
``scpp_tpu/solver/staged.py``).

Constraints are *families*: one symbolic expression emitted for a static
set of nodes at once. A coefficient is either static (a numpy array,
shared by every scenario) or a tensor that carries the scenario batch in
front:

    static term   (dim, w)        or (n_nodes, dim, w)
    tensor term   (B, dim, w)     or (B, n_nodes, dim, w)
    static const  (dim,)          or (n_nodes, dim)
    tensor const  (B, dim)        or (B, n_nodes, dim)
    tensor scalar (B,)

so one builder pass emits the programs of the whole batch. Emission is
one scatter per (family, term), as in the reference. Only per-node
variables are ported: the SCvx subproblem has no global block (g == 0).

Standard form per stage: rows of stage k act on [x_k | x_{k+1}] and read
``A x + s = b, s in {0}^me x R+^l x SOC(q_1) x ...``; padded rows are
0 = 0 equalities, 0 <= 1 slacks and (1, 0...) SOC blocks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from scpp_tpu_torch.trajectory import replace

__all__ = ["StagedBuilder", "StagedProgram", "NodeVar", "NodeExpr",
           "node_concat"]


def _is_static(x) -> bool:
    return not isinstance(x, torch.Tensor)


def _nd(x) -> int:
    """Rank without the batch axis."""
    return np.ndim(x) if _is_static(x) else x.dim() - 1


def _to_tensor(x, like):
    """A static array as a tensor with a unit batch axis."""
    return torch.as_tensor(np.asarray(x), dtype=like.dtype,
                           device=like.device)[None]


def _promote(blocks):
    """If any of the static/tensor arrays is a tensor, turn the static
    ones into tensors with a unit batch axis. Returns (blocks, a tensor
    among them or None)."""
    like = next((b for b in blocks if not _is_static(b)), None)
    if like is None:
        return blocks, None
    return [_to_tensor(b, like) if _is_static(b) else b
            for b in blocks], like


def _add(a, b):
    if _is_static(a) and _is_static(b):
        return a + b
    (a, b), _ = _promote([a, b])
    if _nd(a) < _nd(b):
        a = a.unsqueeze(1)
    elif _nd(b) < _nd(a):
        b = b.unsqueeze(1)
    return a + b


def _scale(s, M):
    """s * M for a static scalar or a per-scenario scalar s (B,)."""
    if _is_static(s):
        return s * M
    if _is_static(M):
        M = _to_tensor(M, s)
    return s.reshape(s.shape + (1,) * _nd(M)) * M


class NodeExpr:
    """Affine expression over per-node variables at a generic node k.

    ``terms[(name, shift)]`` maps a stage variable (shift 0 = node k,
    shift 1 = node k+1) to a coefficient; ``const`` is the offset (see
    the module docstring for the shapes)."""

    __slots__ = ("dim", "terms", "const")
    __array_priority__ = 1000

    def __init__(self, dim: int, terms: Dict, const):
        self.dim = int(dim)
        self.terms = terms
        self.const = const

    @staticmethod
    def _const(value, dim) -> "NodeExpr":
        if _is_static(value):
            v = np.asarray(value, dtype=np.float64)
            if v.ndim == 0:
                v = np.broadcast_to(v, (dim,))
        else:
            v = value
            if v.dim() == 1:
                v = v[:, None].expand(v.shape[0], dim)
        return NodeExpr(dim, {}, v)

    def __add__(self, other) -> "NodeExpr":
        if not isinstance(other, NodeExpr):
            other = NodeExpr._const(other, self.dim)
        if other.dim != self.dim:
            raise ValueError(f"dim mismatch {self.dim} vs {other.dim}")
        terms = dict(self.terms)
        for k, M in other.terms.items():
            terms[k] = _add(terms[k], M) if k in terms else M
        return NodeExpr(self.dim, terms, _add(self.const, other.const))

    __radd__ = __add__

    def __neg__(self) -> "NodeExpr":
        return NodeExpr(self.dim, {k: -M for k, M in self.terms.items()},
                        -self.const)

    def __sub__(self, other) -> "NodeExpr":
        if not isinstance(other, NodeExpr):
            other = NodeExpr._const(other, self.dim)
        return self + (-other)

    def __rsub__(self, other) -> "NodeExpr":
        return (-self) + NodeExpr._const(other, self.dim)

    def __mul__(self, s) -> "NodeExpr":
        """Scale by a static scalar or a per-scenario scalar (B,)."""
        if isinstance(s, NodeExpr):
            raise TypeError("NodeExpr*NodeExpr is not affine")
        if _is_static(s):
            s = float(s)
        elif s.dim() != 1:
            raise ValueError("only (B,) per-scenario scalars scale a NodeExpr")
        return NodeExpr(self.dim,
                        {k: _scale(s, M) for k, M in self.terms.items()},
                        _scale(s, self.const))

    __rmul__ = __mul__

    def __truediv__(self, s) -> "NodeExpr":
        return self * (1.0 / s)

    def sum(self) -> "NodeExpr":
        terms = {}
        for k, M in self.terms.items():
            if _is_static(M):
                terms[k] = M.sum(-2, keepdims=True)
            else:
                terms[k] = M.sum(-2, keepdim=True)
        c = self.const
        const = (c.sum(-1, keepdims=True) if _is_static(c)
                 else c.sum(-1, keepdim=True))
        return NodeExpr(1, terms, const)


def _cat(blocks, axis: int, node_rank: int):
    """Concatenate static/tensor blocks along ``axis`` (from the end),
    promoting shared blocks to per-node where any block is per-node."""
    blocks, like = _promote(blocks)
    if like is None:
        n = next((b.shape[0] for b in blocks if b.ndim == node_rank), None)
        blocks = [np.broadcast_to(b, (n,) + b.shape)
                  if n is not None and b.ndim < node_rank else b
                  for b in blocks]
        return np.concatenate(blocks, axis=axis)
    Bn = max(b.shape[0] for b in blocks)
    n = next((b.shape[1] for b in blocks if _nd(b) == node_rank), None)
    out = []
    for b in blocks:
        if n is not None and _nd(b) < node_rank:
            b = b.unsqueeze(1).expand((b.shape[0], n) + b.shape[1:])
        out.append(b.expand((Bn,) + b.shape[1:]))
    return torch.cat(out, dim=axis)


def node_concat(exprs) -> NodeExpr:
    """Stack NodeExprs along the row dimension."""
    exprs = [e if isinstance(e, NodeExpr) else NodeExpr._const(e, 1)
             for e in exprs]
    dim = sum(e.dim for e in exprs)
    widths = {}
    for e in exprs:
        for k, M in e.terms.items():
            widths[k] = M.shape[-1]
    terms = {}
    for key, w in widths.items():
        blocks = [e.terms.get(key, np.zeros((e.dim, w))) for e in exprs]
        terms[key] = _cat(blocks, -2, 3)
    const = _cat([e.const for e in exprs], -1, 2)
    return NodeExpr(dim, terms, const)


class NodeVar:
    """A per-node variable block of width d (one copy at every stage)."""

    __slots__ = ("name", "d", "n_nodes", "shift")

    def __init__(self, name: str, d: int, n_nodes: int, shift: int = 0):
        self.name = name
        self.d = int(d)
        self.n_nodes = n_nodes
        self.shift = shift

    @property
    def next(self) -> "NodeVar":
        """This variable at node k+1 (for link constraints)."""
        return NodeVar(self.name, self.d, self.n_nodes, self.shift + 1)

    def sel(self, idx=...) -> NodeExpr:
        """Select components: x_k[idx] as a NodeExpr."""
        sel = np.atleast_1d(np.arange(self.d)[idx]).ravel()
        M = np.zeros((sel.size, self.d))
        M[np.arange(sel.size), sel] = 1.0
        return NodeExpr(sel.size, {(self.name, self.shift): M},
                        np.zeros(sel.size))

    def lin(self, M, idx=None) -> NodeExpr:
        """M @ x_k[idx]; M static (r, dsub) / (n_nodes, r, dsub), or a
        tensor (B, r, dsub) / (B, n_nodes, r, dsub)."""
        if _is_static(M):
            M = np.asarray(M)
            if M.ndim == 1:
                M = M[None, :]
        elif M.dim() == 2:
            M = M[:, None, :]
        if idx is None and M.shape[-1] != self.d:
            raise ValueError(f"lin coeff width {M.shape[-1]} != {self.d}")
        if idx is not None:
            sel = np.atleast_1d(np.arange(self.d)[idx]).ravel()
            if M.shape[-1] != sel.size:
                raise ValueError("lin idx width mismatch")
            if _is_static(M):
                full = np.zeros(M.shape[:-1] + (self.d,))
            else:
                full = M.new_zeros(M.shape[:-1] + (self.d,))
            full[..., torch.as_tensor(sel) if not _is_static(M) else sel] = M
            M = full
        r = M.shape[-2]
        const = np.zeros(r) if _nd(M) == 2 else np.zeros((M.shape[-3], r))
        return NodeExpr(r, {(self.name, self.shift): M}, const)


@dataclass
class StagedProgram:
    """Stage-banded standard-form conic programs of a batch.

    Stage rows act on columns [x_k (w) | x_{k+1} (w) | x_glob (g)]; the
    global fields stay empty (g == 0) in this port."""

    A_eq: torch.Tensor           # (B, K, me, 2w+g)
    b_eq: torch.Tensor           # (B, K, me)
    G: torch.Tensor              # (B, K, mc, 2w+g)
    h: torch.Tensor              # (B, K, mc)
    A_geq: torch.Tensor          # (B, meg, g)
    b_geq: torch.Tensor          # (B, meg)
    G_g: torch.Tensor            # (B, mcg, g)
    h_g: torch.Tensor            # (B, mcg)
    c_stage: torch.Tensor        # (B, K, w)
    c_glob: torch.Tensor         # (B, g)
    K: int
    w: int
    g: int
    l: int
    soc_sizes: Tuple[int, ...]
    l_g: int
    soc_sizes_g: Tuple[int, ...]
    stage_layout: Tuple[Tuple[str, int, int, int], ...]
    glob_layout: Tuple[Tuple[str, int, int], ...]

    replace = replace

    @property
    def me(self) -> int:
        return self.A_eq.shape[-2]

    @property
    def mc(self) -> int:
        return self.G.shape[-2]

    def extract(self, sol, name: str) -> torch.Tensor:
        """Pull a named variable out of a (x_stage (B, K, w),
        x_glob (B, g)) solution pair."""
        x_stage, x_glob = sol
        for nm, off, d, n_nodes in self.stage_layout:
            if nm == name:
                return x_stage[..., :n_nodes, off:off + d]
        for nm, off, size in self.glob_layout:
            if nm == name:
                v = x_glob[..., off:off + size]
                return v[..., 0] if size == 1 else v
        raise KeyError(name)


class StagedBuilder:
    """Collects per-node constraint families and emits a
    :class:`StagedProgram` with one scatter per (family, term)."""

    def __init__(self, K: int):
        self.K = int(K)
        self._svars: List[Tuple[str, int, int]] = []   # (name, d, n_nodes)
        self._soff: Dict[str, int] = {}
        self._eq: List[Tuple[NodeExpr, np.ndarray]] = []
        self._nonneg: List[Tuple[NodeExpr, np.ndarray]] = []
        self._socs: List[Tuple[NodeExpr, np.ndarray]] = []
        self._soc_sizes: List[int] = []
        self._cost: List[Tuple[NodeExpr, np.ndarray]] = []

    def stage_var(self, name: str, d: int, n_nodes: int = None) -> NodeVar:
        """Per-node variable of width d; ``n_nodes`` < K only affects
        extract() (an inert padded copy exists at the other stages)."""
        if name in self._soff:
            raise ValueError(f"duplicate variable {name!r}")
        n_nodes = self.K if n_nodes is None else int(n_nodes)
        self._soff[name] = sum(v[1] for v in self._svars)
        self._svars.append((name, int(d), n_nodes))
        return NodeVar(name, d, n_nodes)

    def _nodes(self, expr: NodeExpr, nodes) -> np.ndarray:
        if nodes is None:
            linked = any(sh == 1 for (_, sh) in expr.terms.keys())
            idx = np.arange(self.K - 1 if linked else self.K)
        else:
            idx = np.atleast_1d(np.arange(self.K)[nodes]).ravel()
        for key, M in expr.terms.items():
            if _nd(M) == 3 and M.shape[-3] != idx.size:
                raise ValueError(
                    f"batched coeff for {key} has {M.shape[-3]} slices for "
                    f"{idx.size} nodes")
        c = expr.const
        if _nd(c) == 2 and c.shape[-2] != idx.size:
            raise ValueError("batched const node-count mismatch")
        return idx

    def eq(self, expr: NodeExpr, nodes=None):
        """expr == 0 at each selected node (default: all valid nodes)."""
        self._eq.append((expr, self._nodes(expr, nodes)))

    def nonneg(self, expr: NodeExpr, nodes=None):
        """expr >= 0 elementwise at each selected node."""
        self._nonneg.append((expr, self._nodes(expr, nodes)))

    def soc(self, t, z: NodeExpr, nodes=None):
        """||z||_2 <= t at each selected node; t may be a plain scalar or
        a per-scenario scalar (B,)."""
        if not isinstance(t, NodeExpr):
            t = NodeExpr._const(t, 1)
        if t.dim != 1:
            raise ValueError("SOC t must be scalar")
        stacked = node_concat([t, z])
        self._socs.append((stacked, self._nodes(stacked, nodes)))
        self._soc_sizes.append(stacked.dim)

    def cost(self, expr: NodeExpr, nodes=None):
        """Add sum_k expr_k (scalar per node) to the objective."""
        if expr.dim != 1:
            raise ValueError("cost must be scalar per node")
        self._cost.append((expr, self._nodes(expr, nodes)))

    # ---- emission ----

    def _emit(self, families, negate, pack, Bn, dtype, device, C):
        """families: list of (expr, node_idx) -> (B, K, M, C), (B, K, M).

        negate=True for cone rows (A = -M, b = const); False for
        equalities (A = M, b = -const). ``pack=True`` lets equality
        families with disjoint node sets share row slots (first fit)."""
        K = self.K
        if pack:
            occupancy: List[np.ndarray] = []
            row_assign: List[np.ndarray] = []
            for expr, idx in families:
                rows = []
                for _ in range(expr.dim):
                    for rI, occ in enumerate(occupancy):
                        if not occ[idx].any():
                            rows.append(rI)
                            occ[idx] = True
                            break
                    else:
                        occ = np.zeros(K, bool)
                        occ[idx] = True
                        occupancy.append(occ)
                        rows.append(len(occupancy) - 1)
                row_assign.append(np.asarray(rows))
            m_total = len(occupancy)
        else:
            row_assign = []
            roff = 0
            for expr, _ in families:
                row_assign.append(np.arange(roff, roff + expr.dim))
                roff += expr.dim
            m_total = roff
        A = np.zeros((K, m_total, C))
        b = np.zeros((K, m_total))
        tensor_A, tensor_b = [], []
        sgn = -1.0 if negate else 1.0
        csgn = 1.0 if negate else -1.0
        for (expr, idx), rows in zip(families, row_assign):
            for (name, shift), M in expr.terms.items():
                col0 = shift * (C // 2) + self._soff[name]
                cols = np.arange(col0, col0 + M.shape[-1])
                if _is_static(M):
                    A[np.ix_(idx, rows, cols)] += sgn * (
                        M[None] if M.ndim == 2 else M)
                else:
                    tensor_A.append((idx, rows, cols, M))
            c = expr.const
            if _is_static(c):
                cc = np.asarray(c, np.float64)
                b[np.ix_(idx, rows)] = csgn * (cc[None] if cc.ndim == 1
                                               else cc)
            else:
                tensor_b.append((idx, rows, c))

        def ix(*arrs):
            return tuple(torch.as_tensor(a, device=device) for a in arrs)

        A_t = torch.as_tensor(A, dtype=dtype, device=device).repeat(
            Bn, 1, 1, 1)
        b_t = torch.as_tensor(b, dtype=dtype, device=device).repeat(Bn, 1, 1)
        for idx, rows, cols, M in tensor_A:
            if _nd(M) == 2:
                M = M.unsqueeze(1)
            M = M.to(dtype).expand(Bn, idx.size, rows.size, cols.size)
            I, R, Cc = ix(idx[:, None, None], rows[None, :, None],
                          cols[None, None, :])
            A_t[:, I, R, Cc] += sgn * M
        for idx, rows, c in tensor_b:
            if _nd(c) == 1:
                c = c.unsqueeze(1)
            c = c.to(dtype).expand(Bn, idx.size, rows.size)
            I, R = ix(idx[:, None], rows[None, :])
            b_t[:, I, R] += csgn * c
        return A_t, b_t

    def build(self, batch: int, dtype=None, device="cpu") -> StagedProgram:
        """Emit the programs of a batch of ``batch`` scenarios."""
        dtype = dtype or torch.get_default_dtype()
        K = self.K
        w = sum(v[1] for v in self._svars)
        C = 2 * w
        emit = (lambda fams, neg, pack=False:
                self._emit(fams, neg, pack, batch, dtype, device, C))

        A_eq, b_eq = emit(self._eq, False, pack=True)

        G_non, h_non = emit(self._nonneg, True)
        l = G_non.shape[2]
        pad_non = np.ones((K, l))
        roff = 0
        for expr, idx in self._nonneg:
            pad_non[idx, roff:roff + expr.dim] = 0.0
            roff += expr.dim
        h_non = h_non + torch.as_tensor(pad_non, dtype=dtype, device=device)

        G_soc, h_soc = emit(self._socs, True)
        pad_soc = np.zeros((K, G_soc.shape[2]))
        roff = 0
        for (expr, idx), q in zip(self._socs, self._soc_sizes):
            present = np.zeros(K, bool)
            present[idx] = True
            pad_soc[~present, roff] = 1.0
            roff += q
        h_soc = h_soc + torch.as_tensor(pad_soc, dtype=dtype, device=device)

        G = torch.cat([G_non, G_soc], dim=2)
        h = torch.cat([h_non, h_soc], dim=2)

        c_stage = np.zeros((K, w))
        tensor_cost = []
        for expr, idx in self._cost:
            for (name, shift), M in expr.terms.items():
                if shift != 0:
                    raise ValueError("cost on shifted variables unsupported")
                cols = np.arange(self._soff[name],
                                 self._soff[name] + M.shape[-1])
                if _is_static(M):
                    c_stage[np.ix_(idx, cols)] += (M[0][None] if M.ndim == 2
                                                   else M[:, 0, :])
                else:
                    tensor_cost.append((idx, cols, M))
        c_t = torch.as_tensor(c_stage, dtype=dtype, device=device).repeat(
            batch, 1, 1)
        for idx, cols, M in tensor_cost:
            if _nd(M) == 2:
                M = M.unsqueeze(1)
            M = M[:, :, 0, :].to(dtype).expand(batch, idx.size, cols.size)
            I = torch.as_tensor(idx[:, None], device=device)
            Cc = torch.as_tensor(cols[None, :], device=device)
            c_t[:, I, Cc] += M

        def empty(*shape):
            return torch.zeros((batch,) + shape, dtype=dtype, device=device)

        return StagedProgram(
            A_eq=A_eq, b_eq=b_eq, G=G, h=h,
            A_geq=empty(0, 0), b_geq=empty(0), G_g=empty(0, 0), h_g=empty(0),
            c_stage=c_t, c_glob=empty(0),
            K=K, w=w, g=0, l=l, soc_sizes=tuple(self._soc_sizes),
            l_g=0, soc_sizes_g=(),
            stage_layout=tuple((nm, self._soff[nm], d, n_nodes)
                               for nm, d, n_nodes in self._svars),
            glob_layout=())
