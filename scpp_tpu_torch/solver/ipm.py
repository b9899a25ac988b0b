"""Interior-point solver settings and the batched dense interior-point
SOCP solver (counterpart of ``scpp_tpu/solver/ipm.py``). Field names and
defaults of ``IPMSettings`` match the reference exactly; see it for what
each knob does.

:func:`solve_conic_ipm` is the dense backend: a Mehrotra
predictor-corrector method with Nesterov-Todd scaling over nonneg x SOC
cones, a fixed iteration count with per-scenario convergence masks, the
reduced KKT system solved with two Cholesky factorizations (H-lift and
its Schur complement) and iterative refinement. Every step is a batched
torch op over the scenarios (what ``jax.vmap`` made implicit); nothing
syncs with the host. The cone algebra is the staged IPM's
``_BatchCones`` on one stage, the Ruiz scaling the first-order solver's.
It has no kernel of its own: the reference's has no Pallas call.

Where the port differs: ``kkt_fused`` is accepted and changes nothing.
The reference uses it to choose between XLA ops and a fused Pallas KKT
solve, to save TPU dispatch overhead; in the port every
single-right-hand-side KKT solve of the unfused staged IPM launches the
``cr_solve`` CUDA kernel on the card. The unfused staged solver takes
only ``kkt="cr"``, ``kkt_dtype="working"``, ``refine_f64=False`` and
``"highest"`` precisions, and raises ``NotImplementedError`` for the
rest (``solver/ipm_staged.py:check_unfused_settings``); the dense solver
reads none of the staged knobs, as in the reference."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from scpp_tpu_torch.solver.builder import ConicProgram
from scpp_tpu_torch.solver.scs import SolverResult, _dot, _mtv, _mv, _ruiz
from scpp_tpu_torch.solver.staged_kkt import _cholesky
from scpp_tpu_torch.trajectory import scenario_where

__all__ = ["IPMSettings", "solve_conic_ipm"]


@dataclass(frozen=True)
class IPMSettings:
    iters: int = 25
    step_frac: float = 0.99
    eps_reg: float = 1e-10
    rho_lift: float = 1.0
    eps_feas: float = 1e-9
    ruiz_iters: int = 10
    refine_steps: int = 2
    kkt: str = "cr"
    warm_kappa: float = 0.1
    matmul_precision: str = "highest"
    kkt_precision: str = "highest"
    refine_f64: bool = False
    kkt_dtype: str = "working"
    kkt_fused: bool = False
    monolith: bool = False
    mono_track_best: bool = True

    def replace(self, **changes) -> "IPMSettings":
        return dataclasses.replace(self, **changes)


def solve_conic_ipm(prog: ConicProgram, settings: IPMSettings = IPMSettings()
                    ) -> SolverResult:
    """Mehrotra predictor-corrector IPM on every scenario of the batch;
    returns the same SolverResult as the first-order backend (u/v
    unused)."""
    ne = prog.n_eq
    A_orig, b_orig, c_orig = prog.A, prog.b, prog.c
    Bn, _, n = A_orig.shape
    dtype, dev = A_orig.dtype, A_orig.device
    f = dict(dtype=dtype, device=dev)

    # Ruiz equilibration (cone-block-uniform rows, shared column scaling)
    A_full, D_row, E_col = _ruiz(A_orig, prog, settings.ruiz_iters)
    b_full = D_row * b_orig
    c = E_col * c_orig

    A = A_full[:, :ne]
    b = b_full[:, :ne]
    G = A_full[:, ne:]
    h = b_full[:, ne:]
    # the reference's _ConeOps: the staged IPM's cone algebra on one
    # stage, so its (B, mc) vectors gain a stage axis at each call (W
    # matrices dense, mc x mc, block diagonal); imported here because
    # ipm_staged imports this module for IPMSettings
    from scpp_tpu_torch.solver.ipm_staged import _BatchCones
    ops = _BatchCones(1, prog.n_ineq, prog.soc_sizes)
    mc = ops.mc
    nu_deg = max(ops.deg, 1)
    e_vec = ops.e(dtype, dev)[0]
    eye_n = torch.eye(n, **f)
    eye_e = torch.eye(ne, **f)

    eps = settings.eps_reg
    rho = settings.rho_lift
    At = A.transpose(-1, -2)
    Gt = G.transpose(-1, -2)
    AtA = (At @ A) * rho if ne else torch.zeros((Bn, n, n), **f)

    def kkt_factor(Wrep):
        """Factor the reduced KKT, Jacobi-equilibrating H and the Schur
        complement before the Cholesky so eps_reg acts relative to the
        matrix scale. A failed factor is NaN (``_cholesky``), as
        ``jnp.linalg.cholesky`` returns it."""
        Gw = Wrep["Winv"] @ G
        H = Gw.transpose(-1, -2) @ Gw + AtA
        d1 = 1.0 / torch.sqrt(torch.clamp_min(
            torch.diagonal(H, dim1=-2, dim2=-1), 1e-30))
        Hs = H * d1[:, :, None] * d1[:, None, :] + eps * eye_n
        L1 = _cholesky(Hs)

        def solve_H(r):
            # r: (B, n) or (B, n, k)
            if r.dim() == 2:
                return d1 * torch.cholesky_solve((d1 * r)[..., None],
                                                 L1)[..., 0]
            return d1[:, :, None] * torch.cholesky_solve(
                d1[:, :, None] * r, L1)

        if ne:
            Hinv_At = solve_H(At)
            S = A @ Hinv_At
            d2 = 1.0 / torch.sqrt(torch.clamp_min(
                torch.diagonal(S, dim1=-2, dim2=-1), 1e-30))
            Ss = S * d2[:, :, None] * d2[:, None, :] + eps * eye_e
            L2 = _cholesky(Ss)

            def solve_S(r):
                return d2 * torch.cholesky_solve((d2 * r)[..., None],
                                                 L2)[..., 0]
        else:
            solve_S = None
        return solve_H, solve_S, H

    def winv2(Wrep, v):
        return _mv(Wrep["Winv"], _mv(Wrep["Winv"], v))

    def kkt_solve(fact, Wrep, f1, f2, rz_plus_Wd):
        """Solve the Newton system
            A' dy + G' dz = f1,  A dx = f2,  G dx - W^2 dz = -(rz + W d)
        via the lifted reduced form, polished by ``refine_steps`` sweeps
        of iterative refinement."""
        solve_H, solve_S, H = fact
        u3 = winv2(Wrep, rz_plus_Wd)
        r1l = f1 - _mv(Gt, u3)
        if ne:
            r1l = r1l + _mv(At, rho * f2)

        def schur_pass(g1, g2):
            if ne:
                t = solve_H(g1)
                dy = solve_S(_mv(A, t) - g2)
                dx = solve_H(g1 - _mv(At, dy))
            else:
                dy = torch.zeros((Bn, 0), **f)
                dx = solve_H(g1)
            return dx, dy

        dx, dy = schur_pass(r1l, f2)
        for _ in range(settings.refine_steps):
            res1 = r1l - _mv(H, dx)
            if ne:
                res1 = res1 - _mv(At, dy)
            res2 = (f2 - _mv(A, dx)) if ne else f2
            cx, cy = schur_pass(res1, res2)
            dx = dx + cx
            dy = dy + cy if ne else dy
        dz = winv2(Wrep, _mv(G, dx)) + u3
        return dx, dy, dz

    # ---- initialization (CVXOPT conelp style, W = I) ----
    W0 = ops.identity_rep(dtype, dev)
    fact0 = kkt_factor(W0)
    # primal: min ||s|| s.t. Ax=b, Gx+s=h
    x0, _, _ = kkt_solve(fact0, W0, torch.zeros((Bn, n), **f), b, -h)
    s_cand = h - _mv(G, x0)
    # shift into the interior (CVXOPT conelp init)
    t_p = ops.min_shift(s_cand[:, None])
    s0 = s_cand + torch.where(t_p < -1e-8, torch.zeros_like(t_p),
                              t_p + 1.0)[:, None] * e_vec
    # dual: min ||z|| s.t. A'y + G'z + c = 0
    _, y0, z_cand = kkt_solve(fact0, W0, -c, torch.zeros((Bn, ne), **f),
                              torch.zeros((Bn, mc), **f))
    t_d = ops.min_shift(z_cand[:, None])
    z0 = z_cand + torch.where(t_d < -1e-8, torch.zeros_like(t_d),
                              t_d + 1.0)[:, None] * e_vec

    # convergence on ORIGINAL-space residuals (what callers check)
    bnorm = 1.0 + torch.linalg.vector_norm(b_orig, dim=-1)
    cnorm = 1.0 + torch.linalg.vector_norm(c_orig, dim=-1)
    D_eq, D_c = D_row[:, :ne], D_row[:, ne:]

    x, y, s, z = x0, y0, s0, z0
    done = torch.zeros((Bn,), dtype=torch.bool, device=dev)
    best = [x0, y0, s0, z0, torch.full((Bn,), float("inf"), **f)]
    for _ in range(settings.iters):
        rx = (c + _mv(At, y) if ne else c) + _mv(Gt, z)
        ry = _mv(A, x) - b if ne else torch.zeros((Bn, 0), **f)
        rz = _mv(G, x) + s - h
        gap = _dot(s, z)
        mu = gap / nu_deg

        Wrep, lam = ops.nt_scaling(s[:, None], z[:, None])
        Wrep = {k: v[:, 0] for k, v in Wrep.items()}
        fact = kkt_factor(Wrep)
        lam_lam = ops.mul(lam, lam)
        lam_inv = ops.inv(lam)

        # affine (predictor): d = -lam  =>  rz + W d = rz - s
        dxa, dya, dza = kkt_solve(fact, Wrep, -rx, -ry, rz - s)
        dsa = -_mv(G, dxa) - rz
        a_s = ops.max_step(s[:, None], dsa[:, None])
        a_z = ops.max_step(z[:, None], dza[:, None])
        alpha_aff = torch.clamp_max(torch.minimum(a_s, a_z), 1.0)
        gap_aff = _dot(s + alpha_aff[:, None] * dsa,
                       z + alpha_aff[:, None] * dza)
        sigma = torch.clamp((torch.clamp_min(gap_aff, 0.0)
                             / torch.clamp_min(gap, 1e-30)) ** 3, 0.0, 1.0)

        # corrector + centering:
        # d = lam^-1 o (-lam o lam - (W^-1 dsa) o (W dza) + sigma mu e)
        corr = ops.mul(_mv(Wrep["Winv"], dsa)[:, None],
                       _mv(Wrep["W"], dza)[:, None])
        d = ops.mul(lam_inv, -lam_lam - corr
                    + (sigma * mu)[:, None, None] * e_vec)[:, 0]
        dxc, dyc, dzc = kkt_solve(fact, Wrep, -rx, -ry,
                                  rz + _mv(Wrep["W"], d))
        dsc = -_mv(G, dxc) - rz
        a_s = ops.max_step(s[:, None], dsc[:, None])
        a_z = ops.max_step(z[:, None], dzc[:, None])
        alpha = torch.clamp_max(settings.step_frac * torch.minimum(a_s, a_z),
                                1.0)[:, None]

        x_n = x + alpha * dxc
        y_n = y + alpha * dyc if ne else y
        s_n = s + alpha * dsc
        z_n = z + alpha * dzc

        pres = torch.sqrt(torch.sum((ry / D_eq) ** 2, dim=-1)
                          + torch.sum((rz / D_c) ** 2, dim=-1)) / bnorm
        dres = torch.linalg.vector_norm(rx / E_col, dim=-1) / cnorm
        conv = (pres < settings.eps_feas) & (dres < settings.eps_feas) & \
            (torch.abs(gap) / nu_deg < settings.eps_feas)

        # best-iterate tracking: score every visited iterate and return
        # the best one, not the last one
        score = torch.maximum(torch.maximum(pres, dres), torch.abs(gap)
                              / nu_deg / (1.0 + torch.abs(_dot(c, x))))
        score = torch.where(torch.isfinite(score), score,
                            torch.full_like(score, float("inf")))
        better = score < best[4]
        best = [scenario_where(better, new, old)
                for new, old in zip((x, y, s, z, score), best)]

        # freeze on any numerical blowup: keep last good
        finite = (torch.isfinite(x_n).all(-1) & torch.isfinite(s_n).all(-1)
                  & torch.isfinite(z_n).all(-1))
        if ne:
            finite = finite & torch.isfinite(y_n).all(-1)
        keep = ~done & finite
        done = done | conv | ~finite
        x = scenario_where(keep, x_n, x)
        y = scenario_where(keep, y_n, y) if ne else y
        s = scenario_where(keep, s_n, s)
        z = scenario_where(keep, z_n, z)
    x, y, s, z, _ = best

    # unscale: x = E x^, y = D y^, s = D^-1 s^; residuals on original data
    y_full = torch.cat([y, z], dim=1) if ne else z
    s_full = torch.cat([torch.zeros((Bn, ne), **f), s], dim=1) if ne else s
    x = E_col * x
    y_full = D_row * y_full
    s_full = s_full / D_row
    obj = _dot(c_orig, x)
    res_pri = torch.linalg.vector_norm(_mv(A_orig, x) + s_full - b_orig,
                                       dim=-1) / bnorm
    res_dua = torch.linalg.vector_norm(_mtv(A_orig, y_full) + c_orig,
                                       dim=-1) / cnorm
    by = _dot(b_orig, y_full)
    res_gap = torch.abs(obj + by) / (1.0 + torch.abs(obj) + torch.abs(by))
    zero = torch.zeros((Bn,), **f)
    return SolverResult(x=x, y=y_full, s=s_full, obj=obj,
                        res_pri=res_pri, res_dua=res_dua, res_gap=res_gap,
                        tau=torch.ones((Bn,), **f), kappa=zero,
                        u=torch.zeros((Bn, 1), **f),
                        v=torch.zeros((Bn, 1), **f))
