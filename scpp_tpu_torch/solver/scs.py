"""Batched first-order conic solver (homogeneous self-dual ADMM),
batch-first (counterpart of ``scpp_tpu/solver/scs.py``).

SCS-style Douglas-Rachford splitting on the homogeneous self-dual
embedding:

    u = (x, y, tau),  v = (0, s, kappa)
    u~    <- (I + Q)^-1 (u + v)          Q = [[0, A', c], [-A, 0, b], [-c', -b', 0]]
    u     <- Pi_C(alpha u~ + (1-alpha) u - v),   C = R^n x K* x R+
    v     <- v - (alpha u~ + (1-alpha) u) + u

with a fixed iteration count, Ruiz equilibration (rows of one SOC block
share a scale) and Anderson acceleration (type II, with a growth-reset
safeguard). The reference calls this backend an experimental oracle:
float32 warm re-solves stall near 5e-4 residuals.

Every scenario of the batch runs the same iterations; the reference's
``jnp.where`` selects become per-scenario ``torch.where``, so no
iteration syncs with the host. Each cone projection's SOC part runs
through ``ops/soc_project.py``: the ``soc_project`` CUDA kernel on the
card, whatever ``use_pallas`` says (the reference used that flag to
choose between XLA ops and a Pallas call to save TPU dispatch); each is
counted in ``kernels.solver_calls["soc_projection"]``. The reference's
static size groups of SOC rows (its ``_soc_groups``) are
``ops/soc_project.SocBlocks``, which the projection and its kernel read.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from scpp_tpu_torch import kernels
from scpp_tpu_torch.ops.soc_project import soc_blocks, soc_project_
from scpp_tpu_torch.solver.builder import ConicProgram
from scpp_tpu_torch.trajectory import replace

__all__ = ["SolverSettings", "SolverResult", "solve_conic",
           "project_dual_cone", "project_primal_cone"]


@dataclass(frozen=True)
class SolverSettings:
    iters: int = 400
    ruiz_iters: int = 10
    alpha: float = 1.5              # over-relaxation
    eps: float = 1e-6               # residual target
    warm_start: bool = False
    # Anderson acceleration: memory 0 disables
    aa_memory: int = 10
    aa_reg: float = 1e-8
    aa_safeguard: float = 2.0
    # accepted and changes nothing: on the card every projection launches
    # the soc_project kernel (see the module docstring)
    use_pallas: bool = False

    def replace(self, **changes) -> "SolverSettings":
        return dataclasses.replace(self, **changes)


@dataclass
class SolverResult:
    x: torch.Tensor          # (B, n)
    y: torch.Tensor          # (B, m)
    s: torch.Tensor          # (B, m)
    obj: torch.Tensor        # (B,)
    res_pri: torch.Tensor    # (B,)
    res_dua: torch.Tensor    # (B,)
    res_gap: torch.Tensor    # (B,)
    tau: torch.Tensor        # (B,)
    kappa: torch.Tensor      # (B,)
    # internal scaled iterates for warm starting the next solve
    u: torch.Tensor          # (B, n + m + 1)
    v: torch.Tensor          # (B, n + m + 1)

    replace = replace

    @property
    def solved(self):
        return (self.res_pri < 1e-4) & (self.res_dua < 1e-4) & \
            (self.res_gap < 1e-4)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _mtv(M, v):
    return (M.transpose(-1, -2) @ v[..., None])[..., 0]


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _project_socs_(w, prog: ConicProgram):
    """Project the SOC blocks of w (B, m), a column slice allowed, in
    place; one counted projection when the program has SOC blocks."""
    if prog.soc_sizes:
        kernels.solver_calls["soc_projection"] += 1
        soc_project_(w, soc_blocks(prog.n_eq + prog.n_ineq,
                                   tuple(prog.soc_sizes)))
    return w


def _project_dual_(w, prog: ConicProgram):
    ne, ni = prog.n_eq, prog.n_ineq
    if ni:
        w[:, ne:ne + ni].clamp_(min=0.0)
    return _project_socs_(w, prog)


def project_dual_cone(w, prog: ConicProgram):
    """Project (B, m) onto K* = R^n_eq x R+^n_ineq x prod SOC (SOC
    self-dual)."""
    return _project_dual_(w.clone(), prog)


def project_primal_cone(w, prog: ConicProgram):
    """Project (B, m) onto K = {0}^n_eq x R+^n_ineq x prod SOC (for s)."""
    out = w.clone()
    if prog.n_eq:
        out[:, :prog.n_eq] = 0.0
    return _project_dual_(out, prog)


def _ruiz(A, prog: ConicProgram, iters: int):
    """Ruiz equilibration of A (B, m, n) with cone-block-uniform row
    scaling: returns the scaled A and the row and column scales D (B, m),
    E (B, n)."""
    Bn, m, n = A.shape
    D = torch.ones((Bn, m), dtype=A.dtype, device=A.device)
    E = torch.ones((Bn, n), dtype=A.dtype, device=A.device)
    if m == 0 or n == 0:
        return A, D, E

    # map each row to its cone group (SOC rows share) for uniform scaling
    ne, ni = prog.n_eq, prog.n_ineq
    group_id = np.arange(m)
    gid = ne + ni
    off = ne + ni
    for size in prog.soc_sizes:
        group_id[off:off + size] = gid
        gid += 1
        off += size
    group_id = torch.as_tensor(group_id, device=A.device)
    gids = group_id.expand(Bn, m)
    num_groups = int(gid)

    for _ in range(iters):
        row_norm = torch.amax(torch.abs(A), dim=2)
        # uniform within SOC blocks: the max over each group
        gmax = row_norm.new_zeros((Bn, num_groups)).scatter_reduce(
            1, gids, row_norm, "amax", include_self=False)
        row_norm = gmax[:, group_id]
        d = 1.0 / torch.sqrt(torch.clamp_min(row_norm, 1e-12))
        d = torch.where(row_norm < 1e-12, torch.ones_like(d), d)
        col_norm = torch.amax(torch.abs(A) * d[:, :, None], dim=1)
        e = 1.0 / torch.sqrt(torch.clamp_min(col_norm, 1e-12))
        e = torch.where(col_norm < 1e-12, torch.ones_like(e), e)
        A = d[:, :, None] * A * e[:, None, :]
        D = D * d
        E = E * e
    return A, D, E


def solve_conic(prog: ConicProgram, settings: SolverSettings = SolverSettings(),
                warm: SolverResult = None) -> SolverResult:
    """Solve min c'x s.t. Ax + s = b, s in K for every scenario of the
    batch; ``warm`` (a previous result of the same structure) seeds the
    iterates when ``settings.warm_start``."""
    A0, b0, c0 = prog.A, prog.b, prog.c
    Bn, m, n = A0.shape
    dtype, dev = A0.dtype, A0.device

    # ---- preconditioning ----
    A, D, E = _ruiz(A0, prog, settings.ruiz_iters)
    b = D * b0
    c = E * c0
    # scalar normalization: bring ||b||, ||c|| to O(1)
    scale_b = 1.0 / (1.0 + torch.linalg.vector_norm(b, dim=-1))
    scale_c = 1.0 / (1.0 + torch.linalg.vector_norm(c, dim=-1))
    b = b * scale_b[:, None]
    c = c * scale_c[:, None]

    # ---- cached linear algebra ----
    AtA = A.transpose(-1, -2) @ A
    F = torch.linalg.inv(torch.eye(n, dtype=dtype, device=dev) + AtA)

    def lin_solve(wx, wy):
        x = _mv(F, wx - _mtv(A, wy))
        y = wy + _mv(A, x)
        return x, y

    z1x, z1y = lin_solve(c, b)
    denom = 1.0 + _dot(c, z1x) + _dot(b, z1y)

    def proj_C_(u):
        """C = R^n x K* x R+ (free x, dual-cone y, nonneg tau), in place
        on a fresh (B, L) tensor."""
        _project_dual_(u[:, n:n + m], prog)
        u[:, -1].clamp_(min=0.0)
        return u

    alpha = settings.alpha
    L = n + m + 1

    def T(wvec):
        """One Douglas-Rachford application on the stacked (u, v) state."""
        u, v = wvec[:, :L], wvec[:, L:]
        w = u + v
        z2x, z2y = lin_solve(w[:, :n], w[:, n:n + m])
        tau_t = (w[:, -1] + _dot(c, z2x) + _dot(b, z2y)) / denom
        ux = z2x - tau_t[:, None] * z1x
        uy = z2y - tau_t[:, None] * z1y
        u_t = torch.cat([ux, uy, tau_t[:, None]], dim=1)
        u_r = alpha * u_t + (1.0 - alpha) * u
        u_new = proj_C_(u_r - v)
        v_new = v - u_r + u_new
        return torch.cat([u_new, v_new], dim=1)

    if settings.warm_start and warm is not None:
        u0, v0 = warm.u, warm.v
    else:
        u0 = torch.zeros((Bn, L), dtype=dtype, device=dev)
        u0[:, -1] = 1.0
        v0 = u0.clone()
    w0 = torch.cat([u0, v0], dim=1)

    M = settings.aa_memory
    if M == 0:
        w_final = w0
        for _ in range(settings.iters):
            w_final = T(w_final)
    else:
        w_final = _anderson(T, w0, settings)
        # one final plain DR application guarantees the iterate is a
        # proper projection output (AA steps may leave the cone slightly)
        w_final = T(w_final)

    u, v = w_final[:, :L], w_final[:, L:]

    # ---- recover unscaled solution ----
    tau = u[:, -1]
    kappa = v[:, -1]
    safe_tau = torch.clamp_min(tau, 1e-12)[:, None]
    x_hat = u[:, :n] / safe_tau
    y_hat = u[:, n:n + m] / safe_tau
    s_hat = v[:, n:n + m] / safe_tau

    # x = E x^ / scale_b, s = D^-1 s^ / scale_b, y = D y^ / scale_c
    x = E * x_hat / scale_b[:, None]
    y = D * y_hat / scale_c[:, None]
    s = s_hat / D / scale_b[:, None]

    obj = _dot(c0, x)
    res_pri = torch.linalg.vector_norm(_mv(A0, x) + s - b0, dim=-1) / \
        (1.0 + torch.linalg.vector_norm(b0, dim=-1))
    res_dua = torch.linalg.vector_norm(_mtv(A0, y) + c0, dim=-1) / \
        (1.0 + torch.linalg.vector_norm(c0, dim=-1))
    by = _dot(b0, y)
    res_gap = torch.abs(obj + by) / (1.0 + torch.abs(obj) + torch.abs(by))

    return SolverResult(x=x, y=y, s=s, obj=obj, res_pri=res_pri,
                        res_dua=res_dua, res_gap=res_gap, tau=tau,
                        kappa=kappa, u=u, v=v)


def _anderson(T, w0, settings: SolverSettings):
    """``settings.iters`` Anderson-accelerated (type II) applications of
    the fixed-point map T with the growth-reset safeguard (SCS 2.x): when
    a scenario's residual grows by more than ``aa_safeguard``x, it takes
    a plain step and clears its history. Per scenario throughout."""
    Bn, N2 = w0.shape
    M = settings.aa_memory
    dtype, dev = w0.dtype, w0.device
    slots = torch.arange(M, device=dev)
    eye = torch.eye(M, dtype=dtype, device=dev)
    wc, w_prev = w0, w0
    g_prev = torch.zeros((Bn, N2), dtype=dtype, device=dev)
    gnorm_prev = torch.full((Bn,), float("inf"), dtype=dtype, device=dev)
    S = torch.zeros((Bn, M, N2), dtype=dtype, device=dev)
    Y = torch.zeros((Bn, M, N2), dtype=dtype, device=dev)
    cnt = torch.zeros((Bn,), dtype=torch.long, device=dev)
    for _ in range(settings.iters):
        Tw = T(wc)
        g = Tw - wc
        gnorm = torch.linalg.vector_norm(g, dim=-1)

        grew = gnorm > settings.aa_safeguard * gnorm_prev
        do_reset = (cnt > 0) & grew
        cnt_eff = torch.where(do_reset, torch.zeros_like(cnt), cnt)

        row = torch.clamp_min(cnt_eff - 1, 0) % M
        update = ((slots[None, :] == row[:, None])
                  & (cnt_eff > 0)[:, None])[:, :, None]
        S = torch.where(update, (wc - w_prev)[:, None, :], S)
        Y = torch.where(update, (g - g_prev)[:, None, :], Y)

        m_eff = torch.clamp_max(cnt_eff, M)
        valid = (slots[None, :] < m_eff[:, None]).to(dtype)
        Yv = Y * valid[:, :, None]
        G = Yv @ Yv.transpose(-1, -2) + \
            (settings.aa_reg * (1.0 + gnorm * gnorm))[:, None, None] * eye
        # jnp.linalg.solve never raises: solve_ex, the info left unread
        gamma = torch.linalg.solve_ex(G, _mv(Yv, g))[0] * valid
        w_aa = wc + g - _mtv(S + Y, gamma)

        use_aa = (cnt_eff > 0) & torch.all(torch.isfinite(w_aa), dim=-1)
        w_next = torch.where(use_aa[:, None], w_aa, Tw)
        wc, w_prev, g_prev, gnorm_prev, cnt = \
            w_next, wc, g, gnorm, cnt_eff + 1
    return wc
