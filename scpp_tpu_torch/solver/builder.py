"""Conic problem builder: affine constraints -> standard-form SOCP,
batch-first (counterpart of ``scpp_tpu/solver/builder.py``).

Canonical form:

    minimize    c' x
    subject to  A x + s = b,   s in K = {0}^z x R+^l x SOC(q_1) x ... x SOC(q_N)

The builder collects equality / nonnegativity / second-order-cone
constraints as :class:`Aff` expressions and emits dense batched
``A (B, m, n)``, ``b (B, m)``, ``c (B, n)`` in the reference's row order
(equalities, then nonnegative rows, then the SOC blocks, each in the
order added). Cone structure (row counts, SOC sizes, variable layout) is
static Python data shared by the batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from scpp_tpu_torch.solver.affine import Aff, Var, _is_static, concat
from scpp_tpu_torch.trajectory import replace

__all__ = ["ConeProblemBuilder", "ConicProgram"]


@dataclass
class ConicProgram:
    """Standard-form conic program of a batch; cone layout is static."""

    A: torch.Tensor           # (B, m, n)
    b: torch.Tensor           # (B, m)
    c: torch.Tensor           # (B, n)
    n_eq: int
    n_ineq: int
    soc_sizes: Tuple[int, ...]
    # (name, offset, shape) per variable
    var_layout: Tuple[Tuple[str, int, Tuple[int, ...]], ...]

    replace = replace

    @property
    def n(self) -> int:
        return self.A.shape[-1]

    @property
    def m(self) -> int:
        return self.A.shape[-2]

    def extract(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """Slice a named variable out of stacked solution vectors."""
        for nm, off, shape in self.var_layout:
            if nm == name:
                size = int(np.prod(shape)) if shape else 1
                v = x[..., off:off + size]
                return v.reshape(x.shape[:-1] + shape) if shape else v[..., 0]
        raise KeyError(name)


class ConeProblemBuilder:
    """Accumulates variables, constraints and a linear cost."""

    def __init__(self):
        self._vars: Dict[str, Var] = {}
        self._eq: List[Aff] = []
        self._nonneg: List[Aff] = []
        self._socs: List[Aff] = []       # stacked (t, z) expressions
        self._soc_sizes: List[int] = []
        self._cost: Aff = Aff.constant(0.0)

    # ---- variables ----

    def add_variable(self, name: str, *shape: int) -> Var:
        if name in self._vars:
            raise ValueError(f"duplicate variable {name!r}")
        v = Var(name, shape)
        self._vars[name] = v
        return v

    def var(self, name: str) -> Var:
        return self._vars[name]

    # ---- constraints ----

    def add_eq(self, aff):
        """aff == 0 (elementwise)."""
        self._eq.append(aff if isinstance(aff, Aff) else Aff.constant(aff))

    def add_nonneg(self, aff):
        """aff >= 0 (elementwise)."""
        self._nonneg.append(aff if isinstance(aff, Aff) else Aff.constant(aff))

    def add_box(self, lo, aff, hi):
        """lo <= aff <= hi (cvx::box equivalent)."""
        self.add_nonneg(aff - lo)
        self.add_nonneg(hi - aff)

    def add_soc(self, t, z):
        """||z||_2 <= t; t scalar Aff, z vector Aff."""
        t = t if isinstance(t, Aff) else Aff.constant(t)
        z = z if isinstance(z, Aff) else Aff.constant(z)
        if t.dim != 1:
            raise ValueError("SOC t must be scalar")
        stacked = concat([t, z])
        self._socs.append(stacked)
        self._soc_sizes.append(stacked.dim)

    def add_cost(self, aff):
        """Add a linear cost term (scalar Aff)."""
        aff = aff if isinstance(aff, Aff) else Aff.constant(aff)
        if aff.dim != 1:
            raise ValueError("cost must be scalar")
        self._cost = self._cost + aff

    # ---- canonicalization ----

    def build(self, dtype=None, device=None, batch: int = None
              ) -> ConicProgram:
        """The batched program. Batched coefficients set the batch size,
        dtype and device; a program with static data only takes them from
        the arguments (``batch`` 1, the default dtype, the CPU unless
        given).

        Static blocks are written into one numpy array and moved to the
        device once; each batched block is then copied into its place."""
        names = list(self._vars)
        off = 0
        var_layout, col = [], {}
        for nm in names:
            var_layout.append((nm, off, self._vars[nm].shape))
            col[nm] = off
            off += self._vars[nm].size
        n = off

        # s = aff(x) in K:  b - Ax = Mx + h  =>  A = -M, b = h;
        # aff(x) = 0:       Ax = b           =>  A = M,  b = -h
        rows = [(a, 1.0, -1.0) for a in self._eq] + \
            [(a, -1.0, 1.0) for a in self._nonneg + self._socs]
        m = sum(a.dim for a, _, _ in rows)
        dynamic = [x for a, _, _ in rows
                   for x in list(a.terms.values()) + [a.const]
                   if not _is_static(x)]
        dynamic += [x for x in self._cost.terms.values() if not _is_static(x)]
        if dynamic:
            like = dynamic[0]
            Bn = like.shape[0]
            dtype = dtype or like.dtype
            device = like.device
        else:
            Bn = batch or 1
            dtype = dtype or torch.get_default_dtype()
            device = device or "cpu"
        f = dict(dtype=dtype, device=device)

        A_np, b_np = np.zeros((m, n)), np.zeros(m)
        fills = []                       # (rows, cols, batched block)
        r0 = 0
        for aff, sA, sb in rows:
            r = slice(r0, r0 + aff.dim)
            for nm, blk in aff.terms.items():
                cols = slice(col[nm], col[nm] + self._vars[nm].size)
                if _is_static(blk):
                    A_np[r, cols] = sA * blk
                else:
                    fills.append((r, cols, sA * blk))
            if _is_static(aff.const):
                b_np[r] = sb * aff.const
            else:
                fills.append((r, None, sb * aff.const))
            r0 += aff.dim
        A = torch.as_tensor(A_np, **f).expand(Bn, m, n).clone()
        b = torch.as_tensor(b_np, **f).expand(Bn, m).clone()
        for r, cols, blk in fills:
            if cols is None:
                b[:, r] = blk
            else:
                A[:, r, cols] = blk

        c_np = np.zeros(n)
        c_fills = []
        for nm, blk in self._cost.terms.items():
            cols = slice(col[nm], col[nm] + self._vars[nm].size)
            if _is_static(blk):
                c_np[cols] = np.ravel(blk)
            else:
                c_fills.append((cols, blk.reshape(Bn, -1)))
        c = torch.as_tensor(c_np, **f).expand(Bn, n).clone()
        for cols, blk in c_fills:
            c[:, cols] = blk

        return ConicProgram(
            A=A, b=b, c=c,
            n_eq=sum(a.dim for a in self._eq),
            n_ineq=sum(a.dim for a in self._nonneg),
            soc_sizes=tuple(self._soc_sizes),
            var_layout=tuple(var_layout),
        )
