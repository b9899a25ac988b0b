"""Stage-structured Mehrotra IPM, batch-first (counterpart of
``scpp_tpu/solver/ipm_staged.py``).

The same Nesterov-Todd predictor-corrector method as the monolithic
solve, run as plain torch ops on the :class:`StagedProgram` layout of a
batch: the cone algebra is batched over scenarios and stages, the Gram
matrix G' W^-2 G is assembled as per-stage batched products, and the
Newton KKT system is factored by cyclic reduction
(``solver/staged_kkt.py``). Each single-right-hand-side KKT solve runs
through ``solver/cr_fused.py``: the ``cr_solve`` CUDA kernel on the card.

Solves the standard form emitted by StagedBuilder:
    min c'x  s.t.  A x + s = b,  s in {0}^me x R+^l x SOC(...)  per stage.
Programs with global variables or rows are not ported yet.

Per-scenario semantics: the reference vmaps a ``while_loop``, which
freezes each scenario's carry once its own loop predicate is false. Here
the loop runs while any scenario is live and each step is selected per
scenario with ``torch.where`` (one host sync per IPM iteration).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from scpp_tpu_torch import kernels
from scpp_tpu_torch.solver.cr_fused import cr_pack, cr_solve_single
from scpp_tpu_torch.solver.ipm import IPMSettings
from scpp_tpu_torch.solver.staged import StagedProgram
from scpp_tpu_torch.solver.staged_kkt import cr_factor
from scpp_tpu_torch.trajectory import replace

__all__ = ["solve_staged_ipm", "StagedSolverResult", "check_unfused_settings"]


@dataclass
class StagedSolverResult:
    x_stage: torch.Tensor       # (B, K, w)
    x_glob: torch.Tensor        # (B, g)
    obj: torch.Tensor           # (B,)
    res_pri: torch.Tensor       # (B,)
    res_dua: torch.Tensor       # (B,)
    res_gap: torch.Tensor       # (B,)
    y_stage: torch.Tensor = None   # (B, K, me)
    y_glob: torch.Tensor = None    # (B, meg)
    z_stage: torch.Tensor = None   # (B, K, mc)
    z_glob: torch.Tensor = None    # (B, mcg)

    replace = replace

    @property
    def x(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.x_stage, self.x_glob)


def _soc_offs(l, soc_sizes):
    offs = []
    off = l
    for q in soc_sizes:
        offs.append(off)
        off += q
    return tuple(offs)


def _has_global_rows(prog: StagedProgram) -> bool:
    return bool(prog.g or prog.A_geq.shape[-2] or prog.G_g.shape[-2])


def _staged_ruiz(prog: StagedProgram, iters: int):
    """Ruiz equilibration on the staged layout of a batch without a
    global block: column scales E_st (B, K, w), row scales d_eq (B, K, me)
    and d_c (B, K, mc), uniform within each SOC block."""
    if _has_global_rows(prog):
        raise NotImplementedError("global rows are not ported yet")
    K, w = prog.K, prog.w
    A_eq, G = prog.A_eq, prog.G
    B = A_eq.shape[0]
    ones = dict(dtype=A_eq.dtype, device=A_eq.device)
    E_st = torch.ones((B, K, w), **ones)
    d_eq = torch.ones(A_eq.shape[:3], **ones)
    d_c = torch.ones(G.shape[:3], **ones)
    offs = _soc_offs(prog.l, prog.soc_sizes)

    def colscale_cat(E):
        E_next = torch.cat([E[:, 1:], torch.ones((B, 1, w), **ones)], 1)
        return torch.cat([E, E_next], dim=2)                  # (B, K, 2w)

    def soc_uniform(r):
        parts = [r[..., :prog.l]]
        for o, q in zip(offs, prog.soc_sizes):
            m = torch.amax(r[..., o:o + q], dim=-1, keepdim=True)
            parts.append(m.expand(B, K, q))
        return torch.cat(parts, dim=-1)

    def rowscale(d, r):
        # all-zero rows (padded families) stay unscaled
        return torch.where(r < 1e-12, d, d / torch.sqrt(torch.clamp_min(
            r, 1e-12)))

    for _ in range(iters):
        Ecat = colscale_cat(E_st)[:, :, None, :]
        r_eq = torch.amax(torch.abs(A_eq * d_eq[..., None] * Ecat), dim=3)
        r_c = soc_uniform(torch.amax(torch.abs(G * d_c[..., None] * Ecat),
                                     dim=3))
        d_eq = rowscale(d_eq, r_eq)
        d_c = rowscale(d_c, r_c)

        both = torch.cat([A_eq * d_eq[..., None] * Ecat,
                          G * d_c[..., None] * Ecat], dim=2)
        colmax = torch.amax(torch.abs(both), dim=2)           # (B, K, 2w)
        cm_next = torch.cat([torch.zeros((B, 1, w), **ones),
                             colmax[:, :-1, w:2 * w]], dim=1)
        cmax = torch.maximum(colmax[..., :w], cm_next)
        # empty columns (the virtual control's padded copy) stay unscaled
        E_st = torch.where(cmax < 1e-12, E_st,
                           E_st / torch.sqrt(torch.clamp_min(cmax, 1e-12)))
    return E_st, d_eq, d_c


def _nanmedian(v):
    """Row-wise median of the non-NaN entries of v (B, n), averaging the
    two middle values when their count is even, as numpy's and JAX's
    nanmedian do (torch.nanmedian returns the lower one); NaN for an
    all-NaN row."""
    n = (~torch.isnan(v)).sum(dim=-1, keepdim=True)
    srt = torch.sort(v, dim=-1).values                 # NaN sorts last
    lo = torch.gather(srt, -1, ((n - 1) // 2).clamp_min(0))
    hi = torch.gather(srt, -1, (n // 2).clamp_max(v.shape[-1] - 1))
    med = 0.5 * (lo + hi)
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))[:, 0]


def _equilibrate(prog: StagedProgram, settings: IPMSettings):
    """Ruiz equilibration and the cost/rhs normalization of a batch.

    Returns the scaled (A_eq, G) on the 2w columns [x_k | x_{k+1}], the
    scaled (b_eq, h, c), the scales (E_st, d_eq, d_c, c_scale, b_scale,
    bnorm_o, cnorm_o) that :func:`_post` undoes, and the factors that
    turn scaled residuals into original-space ones (pres_fac, dres_fac).

    The cost is normalized by the MEDIAN of its nonzero entries, not the
    max: Ruiz column scales can blow a single entry up 1e3x, and
    normalizing by that outlier would crush the typical scaled objective
    (see the reference)."""
    K, w = prog.K, prog.w
    B = prog.A_eq.shape[0]
    f = dict(dtype=prog.A_eq.dtype, device=prog.A_eq.device)
    E_st, d_eq, d_c = _staged_ruiz(prog, settings.ruiz_iters)
    Ecat = torch.cat([E_st, torch.cat([E_st[:, 1:],
                                       torch.ones((B, 1, w), **f)], 1)],
                     dim=2)[:, :, None, :]
    A_eq = prog.A_eq[..., :2 * w] * d_eq[..., None] * Ecat
    G = prog.G[..., :2 * w] * d_c[..., None] * Ecat
    b_eq = prog.b_eq * d_eq
    h = prog.h * d_c
    c_st = prog.c_stage * E_st

    cabs = torch.abs(c_st).reshape(B, -1)
    c_scale = torch.clamp_min(
        _nanmedian(torch.where(cabs > 0, cabs, torch.full_like(cabs,
                                                               float("nan")))),
        1.0)
    c_scale = torch.where(torch.isfinite(c_scale), c_scale,
                          torch.ones_like(c_scale))
    b_scale = torch.clamp_min(torch.sqrt(
        torch.sum(b_eq ** 2, dim=(1, 2)) + torch.sum(h ** 2, dim=(1, 2))), 1.0)
    c_st = c_st / c_scale[:, None, None]
    b_eq = b_eq / b_scale[:, None, None]
    h = h / b_scale[:, None, None]

    bnorm_o = 1.0 + torch.sqrt(torch.sum(prog.b_eq ** 2, dim=(1, 2))
                               + torch.sum(prog.h ** 2, dim=(1, 2)))
    cnorm_o = 1.0 + torch.sqrt(torch.sum(prog.c_stage ** 2, dim=(1, 2)))
    pres_fac = b_scale / bnorm_o
    dres_fac = c_scale / cnorm_o
    scales = (E_st, d_eq, d_c, c_scale, b_scale, bnorm_o, cnorm_o)
    return (A_eq, G, b_eq, h, c_st), scales, (pres_fac, dres_fac)


def _post(prog: StagedProgram, x_st, y_st, s_st, z_st, scales):
    """Unscale and compute the original-space residuals."""
    E_st, d_eq, d_c, c_scale, b_scale, bnorm_o, cnorm_o = scales
    w = prog.w
    B = x_st.shape[0]
    f = dict(dtype=x_st.dtype, device=x_st.device)
    bs, cs = b_scale[:, None, None], c_scale[:, None, None]
    x_st = x_st * E_st * bs
    y_st = y_st * d_eq * cs
    z_st = z_st * d_c * cs
    s_u = s_st / d_c * bs

    obj = torch.sum(prog.c_stage * x_st, dim=(1, 2))
    xc = torch.cat([x_st, torch.cat([x_st[:, 1:],
                                     torch.zeros((B, 1, w), **f)], 1)], dim=2)
    A2 = prog.A_eq[..., :2 * w]
    G2 = prog.G[..., :2 * w]
    aeq = (A2 @ xc[..., None])[..., 0]
    gc = (G2 @ xc[..., None])[..., 0]
    res_pri = torch.sqrt(torch.sum((aeq - prog.b_eq) ** 2, dim=(1, 2))
                         + torch.sum((gc + s_u - prog.h) ** 2, dim=(1, 2))
                         ) / bnorm_o
    vc = ((A2.transpose(-1, -2) @ y_st[..., None])[..., 0]
          + (G2.transpose(-1, -2) @ z_st[..., None])[..., 0])
    at_st = vc[..., :w] + torch.cat([torch.zeros((B, 1, w), **f),
                                     vc[:, :-1, w:]], 1)
    res_dua = torch.sqrt(torch.sum((prog.c_stage + at_st) ** 2,
                                   dim=(1, 2))) / cnorm_o
    by = (torch.sum(prog.b_eq * y_st, dim=(1, 2))
          + torch.sum(prog.h * z_st, dim=(1, 2)))
    res_gap = torch.abs(obj + by) / (1.0 + torch.abs(obj) + torch.abs(by))
    return StagedSolverResult(
        x_stage=x_st, x_glob=torch.zeros((B, prog.g), **f), obj=obj,
        res_pri=res_pri, res_dua=res_dua, res_gap=res_gap,
        y_stage=y_st, y_glob=torch.zeros((B, 0), **f), z_stage=z_st,
        z_glob=torch.zeros((B, prog.G_g.shape[-2]), **f))


# ---------------------------------------------------------------------------
# cone algebra
# ---------------------------------------------------------------------------


class _BatchCones:
    """Jordan-algebra ops on slacks shaped (B, n, mc): a batch of B
    scenarios of n stages each, with the static layout
    [nonneg (l) | SOC q_1 | SOC q_2 | ...] shared by every stage. The
    reference's ``_BatchCones`` works on one scenario's (n, mc); here
    every reduction is per scenario and returns (B,).

    All SOC groups are processed in one padded tensor (B, n, S, qmax):
    rows are the S cones, columns padded with zeros up to the widest
    cone, so every reduction only adds zeros."""

    def __init__(self, n: int, l: int, soc_sizes: Tuple[int, ...]):
        self.n = n
        self.l = l
        self.soc_sizes = tuple(soc_sizes)
        self.mc = l + sum(soc_sizes)
        self.soc_offs = _soc_offs(l, self.soc_sizes)
        self.deg = n * (l + len(soc_sizes))
        self.S = len(soc_sizes)
        self.qmax = max(soc_sizes) if soc_sizes else 0
        # gather map (S, qmax) into the padded cone vector [0, mc]; slot mc
        # is an all-zero pad column appended by _gather
        idx = torch.full((self.S, self.qmax), self.mc, dtype=torch.long)
        for i, (o, q) in enumerate(zip(self.soc_offs, self.soc_sizes)):
            idx[i, :q] = o + torch.arange(q)
        self.soc_idx = idx
        self._on = {}

    def _idx(self, like):
        """The gather map on ``like``'s device (copied there once)."""
        key = ("idx", like.device)
        if key not in self._on:
            self._on[key] = self.soc_idx.to(like.device)
        return self._on[key]

    def _jrow(self, like):
        """J = diag(1, -1, ..., -1) as a padded row vector."""
        key = ("J", like.dtype, like.device)
        if key not in self._on:
            j = -torch.ones(self.qmax, dtype=like.dtype, device=like.device)
            j[0] = 1.0
            self._on[key] = j
        return self._on[key]

    def e(self, dtype, device="cpu"):
        """The cone identity, (n, mc)."""
        v = torch.zeros((self.n, self.mc), dtype=dtype, device=device)
        v[:, :self.l] = 1.0
        for o in self.soc_offs:
            v[:, o] = 1.0
        return v

    def _gather(self, u):
        """(..., mc) -> (..., S, qmax) padded SOC blocks (pad slots 0)."""
        u_pad = torch.cat([u, torch.zeros_like(u[..., :1])], dim=-1)
        return u_pad[..., self._idx(u)]

    def _scatter(self, out, vals):
        """Write padded SOC block values (..., S, qmax) into the cone-vector
        positions of ``out`` (..., mc); pad slots land in a sacrificial
        extra column that is sliced off."""
        out = torch.cat([out, torch.zeros_like(out[..., :1])], dim=-1)
        out[..., self._idx(out)] = vals
        return out[..., :self.mc]

    def mul(self, u, v):
        out = torch.zeros_like(u)
        if self.l:
            out[..., :self.l] = u[..., :self.l] * v[..., :self.l]
        if self.S:
            ub, vb = self._gather(u), self._gather(v)
            head = torch.sum(ub * vb, dim=-1, keepdim=True)
            tail = ub[..., :1] * vb[..., 1:] + vb[..., :1] * ub[..., 1:]
            out = self._scatter(out, torch.cat([head, tail], dim=-1))
        return out

    def inv(self, u):
        out = torch.zeros_like(u)
        if self.l:
            out[..., :self.l] = 1.0 / u[..., :self.l]
        if self.S:
            ub = self._gather(u)
            det = ub[..., 0] ** 2 - torch.sum(ub[..., 1:] ** 2, dim=-1)
            Ju = torch.cat([ub[..., :1], -ub[..., 1:]], dim=-1)
            out = self._scatter(out, Ju / det[..., None])
        return out

    def min_shift(self, u):
        """(B, n, mc) -> (B,) the largest interiority defect."""
        out = torch.full(u.shape[:1], float("-inf"), dtype=u.dtype,
                         device=u.device)
        if self.l:
            out = torch.maximum(out, torch.amax(-u[..., :self.l], dim=(1, 2)))
        if self.S:
            ub = self._gather(u)
            d = torch.sqrt(torch.sum(ub[..., 1:] ** 2, dim=-1)) - ub[..., 0]
            out = torch.maximum(out, torch.amax(d, dim=(1, 2)))
        return out

    def max_step(self, u, du):
        """(B, n, mc) x2 -> (B,) the largest step keeping u + a du in the
        cone (capped at 1e20)."""
        big = torch.full((), 1e20, dtype=u.dtype, device=u.device)
        out = big.expand(u.shape[:1])
        if self.l:
            un, dn = u[..., :self.l], du[..., :self.l]
            a = torch.where(dn < 0, -un / torch.where(dn < 0, dn, -1.0), big)
            out = torch.minimum(out, torch.amin(a, dim=(1, 2)))
        if self.S:
            ub, db = self._gather(u), self._gather(du)
            a2 = db[..., 0] ** 2 - torch.sum(db[..., 1:] ** 2, dim=-1)
            b2 = (ub[..., 0] * db[..., 0]
                  - torch.sum(ub[..., 1:] * db[..., 1:], dim=-1))
            c2 = ub[..., 0] ** 2 - torch.sum(ub[..., 1:] ** 2, dim=-1)
            disc = b2 ** 2 - a2 * c2
            sq = torch.sqrt(torch.clamp_min(disc, 0.0))
            root_neg_a = (b2 + sq) / torch.clamp_min(-a2, 1e-30)
            root_pos_a = torch.where(
                (disc > 0) & (b2 < 0),
                c2 / torch.clamp_min(-b2 + sq, 1e-30), big)
            lin = torch.where(b2 < 0,
                              -c2 / (2.0 * torch.where(b2 < 0, b2, -1.0)), big)
            a_soc = torch.where(a2 < -1e-30, root_neg_a,
                                torch.where(a2 > 1e-30, root_pos_a, lin))
            head_cap = torch.where(
                db[..., 0] < 0,
                -ub[..., 0] / torch.where(db[..., 0] < 0, db[..., 0], -1.0),
                big)
            out = torch.minimum(out, torch.amin(
                torch.minimum(a_soc, head_cap), dim=(1, 2)))
        return out

    def nt_scaling(self, s, z):
        """NT scaling point of (B, n, mc) slacks; returns (rep, lam) with
        ``rep`` holding the dense per-stage block-diagonal W / W^-1 / W^-2
        matrices (B, n, mc, mc)."""
        lam = torch.zeros_like(s)
        shape = s.shape[:-1] + (self.mc + 1, self.mc + 1)
        Wd = s.new_zeros(shape)
        Wi = s.new_zeros(shape)
        Wi2 = s.new_zeros(shape)
        if self.l:
            sn, zn = s[..., :self.l], z[..., :self.l]
            dvec = torch.sqrt(sn / zn)
            il = torch.arange(self.l, device=s.device)
            Wd[..., il, il] = dvec
            Wi[..., il, il] = 1.0 / dvec
            Wi2[..., il, il] = 1.0 / dvec ** 2
            lam[..., :self.l] = torch.sqrt(sn * zn)
        if self.S:
            sb = self._gather(s)                              # (B, n, S, q)
            zb = self._gather(z)
            Jrow = self._jrow(s)                              # (q,)
            Jmat = torch.diag(Jrow)                           # (q, q)
            det_s = torch.clamp_min(
                sb[..., 0] ** 2 - torch.sum(sb[..., 1:] ** 2, -1), 1e-30)
            det_z = torch.clamp_min(
                zb[..., 0] ** 2 - torch.sum(zb[..., 1:] ** 2, -1), 1e-30)
            sbar = sb / torch.sqrt(det_s)[..., None]
            zbar = zb / torch.sqrt(det_z)[..., None]
            gamma = torch.sqrt(torch.clamp_min(
                (1.0 + torch.sum(sbar * zbar, -1)) / 2.0, 1e-30))
            wbar = (sbar + zbar * Jrow) / (2.0 * gamma[..., None])
            eta = (det_s / det_z) ** 0.25
            wv = eta[..., None] * wbar
            detw = torch.clamp_min(
                wv[..., 0] ** 2 - torch.sum(wv[..., 1:] ** 2, -1), 1e-30)
            sqrt_detw = torch.sqrt(detw)
            e0 = torch.zeros_like(Jrow)
            e0[0] = 1.0
            u = (wv + sqrt_detw[..., None] * e0) / torch.sqrt(
                2.0 * (wv[..., 0] + sqrt_detw))[..., None]
            detu = sqrt_detw
            Wb = (2.0 * u[..., :, None] * u[..., None, :]
                  - detu[..., None, None] * Jmat)
            uinv = (u * Jrow) / detu[..., None]
            Wib = (2.0 * uinv[..., :, None] * uinv[..., None, :]
                   - (1.0 / detu)[..., None, None] * Jmat)
            # W^-2 blockwise: W is block-diagonal, so squaring the small
            # blocks suffices
            Wi2b = Wib @ Wib
            lam_soc = (Wb @ zb[..., None])[..., 0]
            lam = self._scatter(lam, lam_soc)
            idx = self._idx(s)
            ridx = idx[:, :, None]                            # (S, q, 1)
            cidx = idx[:, None, :]                            # (S, 1, q)
            Wd[..., ridx, cidx] = Wb
            Wi[..., ridx, cidx] = Wib
            Wi2[..., ridx, cidx] = Wi2b
        mc = self.mc
        rep = {"W": Wd[..., :mc, :mc], "Winv": Wi[..., :mc, :mc],
               "Winv2": Wi2[..., :mc, :mc]}
        return rep, lam

    def identity_rep(self, dtype, device="cpu"):
        I = torch.eye(self.mc, dtype=dtype, device=device).expand(
            self.n, self.mc, self.mc)
        return {"W": I, "Winv": I, "Winv2": I}

    def apply_W(self, rep, v):
        return (rep["W"] @ v[..., None])[..., 0]

    def apply_Winv(self, rep, v):
        return (rep["Winv"] @ v[..., None])[..., 0]

    def apply_Winv2(self, rep, v):
        """W^-2 v in one batched product."""
        return (rep["Winv2"] @ v[..., None])[..., 0]

    def apply_Winv_rows(self, rep, M):
        """W^-1 @ M per stage; M: (..., n, mc, C)."""
        return rep["Winv"] @ M


# ---------------------------------------------------------------------------
# the unfused solver
# ---------------------------------------------------------------------------


def check_unfused_settings(settings: IPMSettings):
    """Raise NotImplementedError, naming the knob, for settings that the
    unfused solver of the port does not take yet. ``kkt_fused`` is taken
    and changes nothing: on the card every single-right-hand-side KKT
    solve launches the ``cr_solve`` kernel."""
    if settings.kkt != "cr":
        raise NotImplementedError(f"IPMSettings.kkt={settings.kkt!r} is not "
                                  f"ported (only 'cr')")
    if settings.kkt_dtype != "working":
        raise NotImplementedError(f"IPMSettings.kkt_dtype="
                                  f"{settings.kkt_dtype!r} is not ported")
    if settings.refine_f64:
        raise NotImplementedError("IPMSettings.refine_f64 is not ported")
    for knob in ("matmul_precision", "kkt_precision"):
        if getattr(settings, knob) != "highest":
            raise NotImplementedError(
                f"IPMSettings.{knob}={getattr(settings, knob)!r} is not "
                f"ported: the port runs full precision (no TF32 or bf16)")


def _check_unfused(prog: StagedProgram, settings: IPMSettings):
    if _has_global_rows(prog):
        raise NotImplementedError("global variables or rows (the arrow KKT) "
                                  "are not ported yet")
    check_unfused_settings(settings)


class _StagedIPM:
    """The unfused solve of a batch of programs without a global block
    (the reference's ``_solve_impl`` for gm == 0, ``kkt="cr"``, a factor
    in the working dtype at full precision). The constructor equilibrates;
    :meth:`solve` runs the predictor-corrector loop. The KKT pieces are
    methods so that a check can factor and solve the same systems the
    solver does."""

    def __init__(self, prog: StagedProgram, settings: IPMSettings):
        _check_unfused(prog, settings)
        self.prog, self.st = prog, settings
        self.K, self.w, self.me = prog.K, prog.w, prog.me
        self.B = prog.A_eq.shape[0]
        self.f = dict(dtype=prog.A_eq.dtype, device=prog.A_eq.device)
        (self.A_eq, self.G, self.b_eq, self.h, self.c), self.scales, \
            (self.pres_fac, self.dres_fac) = _equilibrate(prog, settings)
        self.M_st = torch.cat([self.A_eq, self.G], dim=2)  # (B, K, me+mc, 2w)
        self.cones = _BatchCones(self.K, prog.l, prog.soc_sizes)
        self.nu_deg = max(self.cones.deg, 1)
        self.e = self.cones.e(**self.f)
        # set by solve(): per scenario the IPM iterations run, whether the
        # convergence test passed, and the returned (scaled) iterate
        self.iterations = self.converged = self.final = None

    # ---- staged matvecs ----

    def cat_x(self, x):
        x_next = torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)
        return torch.cat([x, x_next], dim=2)

    def uncat(self, xc):
        """Adjoint of cat_x: (B, K, 2w) -> (B, K, w)."""
        w = self.w
        shift = torch.cat([torch.zeros_like(xc[:, :1, :w]),
                           xc[:, :-1, w:2 * w]], dim=1)
        return xc[..., :w] + shift

    def AG_mv(self, x):
        """(A x, G x) in one product."""
        both = (self.M_st @ self.cat_x(x)[..., None])[..., 0]
        return both[..., :self.me], both[..., self.me:]

    def AG_rmv(self, y, z):
        """A' y + G' z in one product."""
        vc = torch.cat([y, z], dim=2)
        return self.uncat((self.M_st.transpose(-1, -2) @ vc[..., None])[..., 0])

    def G_mv(self, x):
        return (self.G @ self.cat_x(x)[..., None])[..., 0]

    @staticmethod
    def dot(a, b):
        return torch.sum(a * b, dim=(1, 2))

    # ---- KKT factor / solve ----

    def kkt_blocks(self, rep):
        """The diagonal and sub-diagonal blocks (D, O) of the regularized
        KKT matrix for the scaling ``rep``:
        H = G' W^-2 G + rho A'A (the rho-lift keeps the primal pivots
        positive-definite along directions whose cone rows go inactive)."""
        st, w, me, K = self.st, self.w, self.me, self.K
        eps = delta = st.eps_reg
        A_eq = self.A_eq
        sqrho = torch.sqrt(torch.as_tensor(st.rho_lift, **self.f))
        Gw = self.cones.apply_Winv_rows(rep, self.G)          # (B, K, mc, 2w)
        Gw = torch.cat([Gw, sqrho * A_eq], dim=2)
        Gam = Gw.transpose(-1, -2) @ Gw                       # (B, K, 2w, 2w)
        Hxx = Gam[..., :w, :w]
        Hnn = Gam[..., w:2 * w, w:2 * w]
        Hxn = Gam[..., w:2 * w, :w]

        Dxx = eps * torch.eye(w, **self.f) + Hxx
        Dxx = torch.cat([Dxx[:, :1], Dxx[:, 1:] + Hnn[:, :-1]], dim=1)
        Dxy = A_eq[..., :w].transpose(-1, -2)                 # (B, K, w, me)
        Dyy = (-delta * torch.eye(me, **self.f)).expand(self.B, K, me, me)
        D = torch.cat([torch.cat([Dxx, Dxy], dim=3),
                       torch.cat([Dxy.transpose(-1, -2), Dyy], dim=3)], dim=2)
        Oxx = Hxn[:, :-1]                                     # (B, K-1, w, w)
        Oxy = A_eq[:, :-1, :, w:2 * w].transpose(-1, -2)      # (B, K-1, w, me)
        O = torch.cat([torch.cat([Oxx, Oxy], dim=3),
                       A_eq.new_zeros((self.B, K - 1, me, w + me))], dim=2)
        return D, O

    def kkt_factor(self, rep):
        D, O = self.kkt_blocks(rep)
        return cr_pack(cr_factor(D, O, self.w))

    def kkt_raw_solve(self, fact, r_x, r_y):
        """One regularized-KKT solve, single right-hand side."""
        kernels.solver_calls["raw_kkt_solve"] += 1
        sol = cr_solve_single(fact, torch.cat([r_x, r_y], dim=2))
        return sol[..., :self.w], sol[..., self.w:]

    def kkt_solve(self, fact, rep, f1, f2, rzWd, refine_steps):
        """Solve  H dx + A' dy = f1 - G' W^-2 (rz + W d),  A dx = f2,
        recover dz = W^-2 (G dx) + u3; refined against the exact
        (unregularized) operator."""
        rho, cones = self.st.rho_lift, self.cones
        u3 = cones.apply_Winv2(rep, rzWd)
        r1 = f1 + self.AG_rmv(rho * f2, -u3)
        dx, dy = self.kkt_raw_solve(fact, r1, f2)
        for _ in range(refine_steps):
            ax, gx = self.AG_mv(dx)
            wx = cones.apply_Winv2(rep, gx)
            mx = self.AG_rmv(rho * ax + dy, wx)
            cx, cy = self.kkt_raw_solve(fact, r1 - mx, f2 - ax)
            dx = dx + cx
            dy = dy + cy
        dz = cones.apply_Winv2(rep, self.G_mv(dx)) + u3
        return dx, dy, dz

    # ---- the iteration ----

    def residuals_and_score(self, x, y, s, z):
        """KKT residuals of an iterate and the original-space score used
        for best-iterate tracking, per scenario."""
        E_st, d_eq, d_c, c_scale, b_scale = self.scales[:5]
        rx = self.c + self.AG_rmv(y, z)
        a, gv = self.AG_mv(x)
        ry = a - self.b_eq
        rz = gv + s - self.h
        gap = self.dot(s, z)
        pres = torch.sqrt(torch.sum((ry / d_eq) ** 2, dim=(1, 2))
                          + torch.sum((rz / d_c) ** 2, dim=(1, 2))
                          ) * self.pres_fac
        dres = torch.sqrt(torch.sum((rx / E_st) ** 2, dim=(1, 2))
                          ) * self.dres_fac
        obj_now = self.dot(self.c, x)
        # the gap in original units, relative to the original-scale
        # primal and dual objectives
        by_now = self.dot(self.b_eq, y) + self.dot(self.h, z)
        cb = c_scale * b_scale
        relgap = (cb * torch.abs(gap)
                  / (1.0 + cb * (torch.abs(obj_now) + torch.abs(by_now))))
        score = torch.maximum(torch.maximum(pres, dres), relgap)
        score = torch.where(torch.isfinite(score), score,
                            torch.full_like(score, float("inf")))
        return rx, ry, rz, gap, pres, dres, relgap, score

    def init_point(self, warm, warm_ok):
        """CVXOPT conelp-style cold start, or the warm start of the
        scenarios where ``warm_ok`` (B,) holds."""
        st, cones, e = self.st, self.cones, self.e
        E_st, d_eq, d_c, c_scale, b_scale = self.scales[:5]
        w3 = warm_ok[:, None, None]
        rep0 = cones.identity_rep(**self.f)
        fact0 = self.kkt_factor(rep0)
        zeros = torch.zeros_like
        x0, _, _ = self.kkt_solve(fact0, rep0, zeros(self.c), self.b_eq,
                                  -self.h, 0)
        if warm is not None:
            # warm primal in this problem's equilibrated space; slacks are
            # re-derived below as h - G x against the new data
            x0 = torch.where(w3, warm.x_stage / (E_st * b_scale[:, None, None]),
                             x0)
        kappa = st.warm_kappa
        s_cand = self.h - self.G_mv(x0)
        t_p = cones.min_shift(s_cand)
        shift_p = torch.where(t_p < -1e-8, torch.zeros_like(t_p), t_p + 1.0)
        if warm is not None:
            # warm margin: shift only as far as interiority + kappa needs
            shift_p = torch.where(warm_ok, torch.clamp_min(t_p + kappa, 0.0),
                                  shift_p)
        s0 = s_cand + shift_p[:, None, None] * e

        _, y0, z0c = self.kkt_solve(fact0, rep0, -self.c, zeros(self.b_eq),
                                    zeros(self.h), 0)
        if warm is not None:
            cs = c_scale[:, None, None]
            y0 = torch.where(w3, warm.y_stage / (d_eq * cs), y0)
            z0c = torch.where(w3, warm.z_stage / (d_c * cs), z0c)
        t_d = cones.min_shift(z0c)
        shift_d = torch.where(t_d < -1e-8, torch.zeros_like(t_d), t_d + 1.0)
        if warm is not None:
            shift_d = torch.where(warm_ok, torch.clamp_min(t_d + kappa, 0.0),
                                  shift_d)
        z0 = z0c + shift_d[:, None, None] * e
        return x0, y0, s0, z0

    def step(self, x, y, s, z):
        """One predictor-corrector iteration of every scenario. Returns the
        stepped iterate, the converged flags and the finite flags of the
        step, and the score of the incoming iterate."""
        st, cones, e = self.st, self.cones, self.e
        rx, ry, rz, gap, pres, dres, relgap, score = \
            self.residuals_and_score(x, y, s, z)
        mu = gap / self.nu_deg

        rep, lam = cones.nt_scaling(s, z)
        fact = self.kkt_factor(rep)
        lam_lam = cones.mul(lam, lam)
        lam_inv = cones.inv(lam)

        def col(v):
            return v[:, None, None]

        # predictor
        dxa, dya, dza = self.kkt_solve(fact, rep, -rx, -ry, rz - s,
                                       st.refine_steps)
        dsa = -self.G_mv(dxa) - rz
        # s and z share the cone layout: one stacked max_step gives
        # min(a_s, a_z)
        a_sz = cones.max_step(torch.cat([s, z], 1), torch.cat([dsa, dza], 1))
        alpha_aff = torch.clamp_max(a_sz, 1.0)
        gap_aff = self.dot(s + col(alpha_aff) * dsa, z + col(alpha_aff) * dza)
        sigma = torch.clip((torch.clamp_min(gap_aff, 0.0)
                            / torch.clamp_min(gap, 1e-30)) ** 3, 0.0, 1.0)
        # a non-finite predictor must not poison the corrector: fall back
        # to a pure centering step
        sigma = torch.where(torch.isfinite(sigma), sigma,
                            torch.ones_like(sigma))

        # corrector (the Mehrotra second-order term is dropped if the
        # predictor broke down)
        corr = cones.mul(cones.apply_Winv(rep, dsa), cones.apply_W(rep, dza))
        corr = torch.where(torch.isfinite(corr), corr, torch.zeros_like(corr))
        d_st = cones.mul(lam_inv, -lam_lam - corr + col(sigma * mu) * e)
        dxc, dyc, dzc = self.kkt_solve(fact, rep, -rx, -ry,
                                       rz + cones.apply_W(rep, d_st),
                                       st.refine_steps)
        dsc = -self.G_mv(dxc) - rz
        a_sz = cones.max_step(torch.cat([s, z], 1), torch.cat([dsc, dzc], 1))
        alpha = col(torch.clamp_max(st.step_frac * a_sz, 1.0))

        x_n, y_n = x + alpha * dxc, y + alpha * dyc
        s_n, z_n = s + alpha * dsc, z + alpha * dzc
        conv = ((pres < st.eps_feas) & (dres < st.eps_feas)
                & (relgap < st.eps_feas))

        def finite(t):
            return torch.isfinite(t).all(dim=2).all(dim=1)

        fin = finite(x_n) & finite(s_n) & finite(z_n)
        return (x_n, y_n, s_n, z_n), conv, fin, score

    def solve(self, warm: StagedSolverResult = None, warm_ok=False):
        B, st = self.B, self.st
        dev = self.f["device"]
        warm_ok = torch.as_tensor(warm_ok, device=dev).expand(B)
        it = self.init_point(warm, warm_ok)
        best = it
        bscore = torch.full((B,), float("inf"), **self.f)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        converged = torch.zeros_like(done)
        iters = torch.zeros((B,), dtype=torch.long, device=dev)

        def sel(mask, new, old):
            m = mask[:, None, None]
            return tuple(torch.where(m, a, b) for a, b in zip(new, old))

        for _ in range(st.iters):
            live = ~done
            if not bool(live.any()):
                break
            new, conv, fin, score = self.step(*it)
            better = live & (score < bscore)
            best = sel(better, it, best)
            bscore = torch.where(better, score, bscore)
            it = sel(live & fin, new, it)
            done = done | (live & (conv | ~fin))
            converged = converged | (live & conv)
            iters = iters + live.long()

        # score the final stepped iterate into the best: the loop scores
        # the pre-step iterate, so on the exiting iteration the fresh step
        # would otherwise go unscored
        fscore = self.residuals_and_score(*it)[-1]
        best = sel(fscore < bscore, it, best)
        self.iterations, self.converged, self.final = iters, converged, best
        return _post(self.prog, best[0], best[1], best[2], best[3],
                     self.scales)


def solve_staged_ipm(prog: StagedProgram,
                     settings: IPMSettings = IPMSettings(),
                     warm: StagedSolverResult = None,
                     warm_ok=False) -> StagedSolverResult:
    """Solve a batch of staged conic programs.

    ``warm`` is a previous result on same-structured programs: its primal
    is the initial x (slacks re-derived as h - G x against the new data),
    its duals the initial (y, z), each shifted into the cone interior by
    ``settings.warm_kappa``. ``warm_ok`` (bool or (B,) bool) selects warm
    or cold per scenario.

    ``settings.monolith`` routes the programs the monolith takes
    (``ipm_mono.mono_supported``) to the monolithic solve; everything
    else runs the unfused solver here, as in the reference. What neither
    takes raises ``NotImplementedError`` naming the knob."""
    if settings.monolith:
        from scpp_tpu_torch.solver.ipm_mono import (mono_supported,
                                                    solve_staged_ipm_mono)
        if mono_supported(prog, settings):
            return solve_staged_ipm_mono(prog, settings, warm, warm_ok)
    return _StagedIPM(prog, settings).solve(warm, warm_ok)
