"""Monolithic staged IPM: the whole conic solve of a batch in one launch
(counterpart of ``scpp_tpu/solver/ipm_mono.py``).

``_prep`` (Ruiz equilibration and cost/rhs normalization, shared with
the unfused solver as ``ipm_staged._equilibrate``, and the warm-start
scaling) and ``_post`` (unscaling, original-space residuals; shared, in
``ipm_staged``) run as plain torch. Between them, ``mono_solve`` runs the NT-Mehrotra
predictor-corrector solve: on a CUDA tensor it launches the hand-written
kernel ``csrc/mono_ipm.cu`` (one thread block per scenario) or raises;
on a CPU tensor it runs ``_solve_block``, the kernel's plain version.
Both factor the staged KKT system by cyclic reduction in the reference's
order (``staged_kkt.cr_factor`` with ``mono_blocks.mono_inverse_factor``,
the reference's ``mono_cr_factor``) and solve it with
``staged_kkt.cr_solve``.

Per-scenario iteration counts: ``diag[:, 0, 1]`` counts the iterations
of each scenario on its own, in the kernel and in ``_solve_block`` alike
(the JAX kernel counts per sub-batch of ``MONO_BSUB`` scenarios).

``part`` isolates a piece of the solve, as the reference's hook does
(``scpp_tpu_torch/diag/mono_parts.py`` times them): ``"init"`` returns
the starting point and a zero diag before any iteration; ``"iter<N>"``
runs the iteration exactly N times, whatever ``settings.iters`` and the
all-done test say (done scenarios stay frozen by the masks); anything
else is the whole solve. ``prof`` (the kernel only) takes its per-phase
clock counters (``PHASES``).
"""

from __future__ import annotations

import ctypes

import torch

from scpp_tpu_torch import kernels
from scpp_tpu_torch.solver.ipm import IPMSettings
from scpp_tpu_torch.solver.ipm_staged import (StagedSolverResult,
                                             _equilibrate, _post)
from scpp_tpu_torch.solver.mono_blocks import mono_inverse_factor
from scpp_tpu_torch.solver.mono_cones import MonoCones
from scpp_tpu_torch.solver.staged import StagedProgram
from scpp_tpu_torch.solver.staged_kkt import cr_factor, cr_solve

__all__ = ["mono_supported", "mono_solve", "solve_staged_ipm_mono"]


def mono_supported(prog: StagedProgram, settings: IPMSettings) -> bool:
    """The monolith covers the trajectory-subproblem class: no global
    block, at least one equality row per stage, full-precision lanes.
    The reference's w % 8 / me % 8 rules answer the TPU's tiling and do
    not apply here; me > 0 is required (a zero-width dual block), and
    programs without equality rows take the unfused solver."""
    gm_zero = (prog.g == 0 and prog.A_geq.shape[-2] == 0
               and prog.G_g.shape[-2] == 0)
    return (gm_zero and prog.me > 0
            and settings.kkt_dtype == "working"
            and not settings.refine_f64
            and settings.matmul_precision == "highest"
            and settings.kkt_precision == "highest")


# ---------------------------------------------------------------------------
# the plain version of the kernel, on (B, K, ...) tensors
# ---------------------------------------------------------------------------


def part_code(part: str) -> int:
    """The kernel's encoding of ``part``: -2 for ``"init"``, N >= 0 for
    ``"iter<N>"``, -1 for the whole solve."""
    if part == "init":
        return -2
    if part.startswith("iter"):
        n = int(part[4:])
        if n < 0:
            raise ValueError(f"part {part!r}: the iteration count is negative")
        return n
    return -1


def _solve_block(statics, AT, GT, b_eq, h, c, d_eq, d_c, E_st, scal,
                 warm_x, warm_y, warm_z, part="full"):
    """The complete IPM solve of a batch of equilibrated programs, or the
    piece of it that ``part`` names (see the module docstring).

    statics: (K, w, me, l, soc_sizes, settings); AT/GT are the transposed
    constraint blocks (B, K, 2w, me) / (B, K, 2w, mc); ``scal`` (B, 1, 4)
    = [pres_fac, dres_fac, c_scale * b_scale, warm_ok]. Returns x, y, s,
    z and diag (B, 1, 4) = [score, iterations, 0, 0]."""
    code = part_code(part)
    K, w, me, l, soc_sizes, st = statics
    B = AT.shape[0]
    f = dict(dtype=AT.dtype, device=AT.device)
    cones = MonoCones(l, soc_sizes, AT.dtype, AT.device)
    e_st = cones.e
    nu_deg = max(K * cones.deg_per_stage, 1)
    eps = delta = st.eps_reg
    rho = st.rho_lift

    scal = scal.reshape(B, 4)
    pres_fac, dres_fac, cb = scal[:, 0:1], scal[:, 1:2], scal[:, 2:3]
    warm_ok = scal[:, 3:4] > 0.5                               # (B, 1)
    warm3 = warm_ok[:, :, None]
    ATt = AT.transpose(-1, -2)
    GTt = GT.transpose(-1, -2)

    def cat_x(x):
        x_next = torch.cat([x[:, 1:], torch.zeros((B, 1, w), **f)], 1)
        return torch.cat([x, x_next], dim=2)

    def uncat(v):
        shift = torch.cat([torch.zeros((B, 1, w), **f), v[:, :-1, w:]], 1)
        return v[..., :w] + shift

    def A_mv(x):
        return (ATt @ cat_x(x)[..., None])[..., 0]

    def G_mv(x):
        return (GTt @ cat_x(x)[..., None])[..., 0]

    def AG_rmv(y, z):
        return uncat((AT @ y[..., None])[..., 0] + (GT @ z[..., None])[..., 0])

    def sdot(a, b):
        return torch.sum(a * b, dim=(1, 2))[:, None]

    def snorm2(t):
        return torch.sum(t * t, dim=(1, 2))[:, None]

    I_w = torch.eye(w, **f)
    I_me = torch.eye(me, **f)

    def kkt_factor(rep_rows):
        GwT = cones.apply_Winv(rep_rows, GT)                  # (B,K,2w,mc)
        Gam = GwT @ GwT.transpose(-1, -2)
        Gam = Gam + rho * (AT @ ATt)
        Hxx, Hnn, Hxn = Gam[..., :w, :w], Gam[..., w:, w:], Gam[..., w:, :w]
        Dxx = eps * I_w + Hxx
        Dxx = Dxx + torch.cat([torch.zeros((B, 1, w, w), **f), Hnn[:, :-1]],
                              dim=1)
        Dxy = AT[:, :, :w, :]
        Dyy = (-delta * I_me).expand(B, K, me, me)
        D = torch.cat([torch.cat([Dxx, Dxy], dim=3),
                       torch.cat([Dxy.transpose(-1, -2), Dyy], dim=3)], dim=2)
        O = torch.cat([torch.cat([Hxn[:, :-1], AT[:, :-1, w:, :]], dim=3),
                       torch.zeros((B, K - 1, me, w + me), **f)], dim=2)
        return cr_factor(D, O, w, inverse_factor=mono_inverse_factor)

    def kkt_raw_solve(fact, r_x, r_y):
        sol = cr_solve(fact, torch.cat([r_x, r_y], dim=2))
        return sol[..., :w], sol[..., w:]

    def kkt_solve(fact, rep, f1, f2, rzWd, refine_steps):
        u3 = cones.apply_Winv2(rep, rzWd)
        r1 = f1 + AG_rmv(rho * f2, -u3)
        dx, dy = kkt_raw_solve(fact, r1, f2)
        for _ in range(refine_steps):
            ax, gx = A_mv(dx), G_mv(dx)
            mx = AG_rmv(rho * ax + dy, cones.apply_Winv2(rep, gx))
            cx, cy = kkt_raw_solve(fact, r1 - mx, f2 - ax)
            dx = dx + cx
            dy = dy + cy
        dz = cones.apply_Winv2(rep, G_mv(dx)) + u3
        return dx, dy, dz

    def rows(rep):
        return {k: v[:, :, None, :] for k, v in rep.items()}

    # ---- initialization (conelp-style cold start, or warm start) ----
    rep0 = cones.identity_rep()
    fact0 = kkt_factor(rep0)
    zeros_w = torch.zeros((B, K, w), **f)
    zeros_me = torch.zeros((B, K, me), **f)
    zeros_mc = torch.zeros((B, K, l + sum(soc_sizes)), **f)
    kappa = st.warm_kappa

    x0, _, _ = kkt_solve(fact0, rep0, zeros_w, b_eq, -h, 0)
    x0 = torch.where(warm3, warm_x, x0)
    s_cand = h - G_mv(x0)
    t_p = cones.min_shift(s_cand)                             # (B, 1)
    shift_p = torch.where(t_p < -1e-8, torch.zeros_like(t_p), t_p + 1.0)
    shift_p = torch.where(warm_ok, torch.clamp_min(t_p + kappa, 0.0),
                          shift_p)
    s0 = s_cand + shift_p[:, :, None] * e_st

    _, y0, z0c = kkt_solve(fact0, rep0, -c, zeros_me, zeros_mc, 0)
    y0 = torch.where(warm3, warm_y, y0)
    z0c = torch.where(warm3, warm_z, z0c)
    t_d = cones.min_shift(z0c)
    shift_d = torch.where(t_d < -1e-8, torch.zeros_like(t_d), t_d + 1.0)
    shift_d = torch.where(warm_ok, torch.clamp_min(t_d + kappa, 0.0),
                          shift_d)
    z0 = z0c + shift_d[:, :, None] * e_st
    if code == -2:
        return x0, y0, s0, z0, torch.zeros((B, 1, 4), **f)

    def residuals_and_score(x, y, s, z):
        rx = c + AG_rmv(y, z)
        ry = A_mv(x) - b_eq
        rz = G_mv(x) + s - h
        gap = sdot(s, z)
        pres = torch.sqrt(snorm2(ry / d_eq) + snorm2(rz / d_c)) * pres_fac
        dres = torch.sqrt(snorm2(rx / E_st)) * dres_fac
        obj_now = sdot(c, x)
        by_now = sdot(b_eq, y) + sdot(h, z)
        relgap = (cb * torch.abs(gap)
                  / (1.0 + cb * (torch.abs(obj_now) + torch.abs(by_now))))
        score = torch.maximum(torch.maximum(pres, dres), relgap)
        score = torch.where(torch.isfinite(score), score,
                            torch.full_like(score, float("inf")))
        return rx, ry, rz, gap, pres, dres, relgap, score

    def sfinite(t):
        return torch.isfinite(t).all(dim=2).all(dim=1, keepdim=True)

    track_best = st.mono_track_best
    x, y, s, z = x0, y0, s0, z0
    bx, by_, bs, bz = x0, y0, s0, z0
    bscore = torch.full((B, 1), float("inf"), **f)
    done = torch.zeros((B, 1), dtype=torch.bool, device=AT.device)
    iters = torch.zeros((B, 1), **f)
    for _ in range(code if code >= 0 else st.iters):
        if code < 0 and bool(done.all()):
            break
        active = ~done
        iters = iters + active.to(iters.dtype)
        rx, ry, rz, gap, pres, dres, relgap, score = \
            residuals_and_score(x, y, s, z)
        mu = gap / nu_deg

        rep, lam = cones.nt_scaling(s, z)
        fact = kkt_factor(rows(rep))
        lam_lam = cones.mul(lam, lam)
        lam_inv = cones.inv(lam)

        dxa, dya, dza = kkt_solve(fact, rep, -rx, -ry, rz - s,
                                  st.refine_steps)
        dsa = -G_mv(dxa) - rz
        a_sz = torch.minimum(cones.max_step(s, dsa), cones.max_step(z, dza))
        alpha_aff = torch.clamp_max(a_sz, 1.0)
        gap_aff = sdot(s + alpha_aff[:, :, None] * dsa,
                       z + alpha_aff[:, :, None] * dza)
        ratio = torch.clamp_min(gap_aff, 0.0) / torch.clamp_min(gap, 1e-30)
        sigma = torch.clip(ratio * ratio * ratio, 0.0, 1.0)
        sigma = torch.where(torch.isfinite(sigma), sigma,
                            torch.ones_like(sigma))

        corr = cones.mul(cones.apply_Winv(rep, dsa), cones.apply_W(rep, dza))
        corr = torch.where(torch.isfinite(corr), corr, torch.zeros_like(corr))
        d_st = cones.mul(
            lam_inv, -lam_lam - corr + (sigma * mu)[:, :, None] * e_st)
        dxc, dyc, dzc = kkt_solve(fact, rep, -rx, -ry,
                                  rz + cones.apply_W(rep, d_st),
                                  st.refine_steps)
        dsc = -G_mv(dxc) - rz
        a_sz = torch.minimum(cones.max_step(s, dsc), cones.max_step(z, dzc))
        alpha = torch.clamp_max(st.step_frac * a_sz, 1.0)[:, :, None]

        x_n = x + alpha * dxc
        y_n = y + alpha * dyc
        s_n = s + alpha * dsc
        z_n = z + alpha * dzc

        conv = ((pres < st.eps_feas) & (dres < st.eps_feas)
                & (relgap < st.eps_feas))
        if track_best:
            better = (score < bscore)[:, :, None]
            bx = torch.where(better, x, bx)
            by_ = torch.where(better, y, by_)
            bs = torch.where(better, s, bs)
            bz = torch.where(better, z, bz)
            bscore = torch.minimum(score, bscore)

        finite = sfinite(x_n) & sfinite(s_n) & sfinite(z_n)
        done = done | (active & conv) | ~finite
        keep = (active & finite)[:, :, None]
        x = torch.where(keep, x_n, x)
        y = torch.where(keep, y_n, y)
        s = torch.where(keep, s_n, s)
        z = torch.where(keep, z_n, z)

    *_, fscore = residuals_and_score(x, y, s, z)
    if track_best:
        fbetter = (fscore < bscore)[:, :, None]
        x, y, s, z = (torch.where(fbetter, x, bx), torch.where(fbetter, y, by_),
                      torch.where(fbetter, s, bs), torch.where(fbetter, z, bz))
    diag = torch.cat([torch.minimum(fscore, bscore), iters,
                      torch.zeros((B, 2), **f)], dim=1)[:, None, :]
    return x, y, s, z, diag


# ---------------------------------------------------------------------------
# the kernel and its wrapper
# ---------------------------------------------------------------------------

# The kernel's phase counters (csrc/mono_ipm_body.cuh, enum Phase), in
# order; a (B, PROF_SLOTS) int64 buffer holds each block's clock64()
# cycles per phase, then its whole run in cycles and in globaltimer ns.
PHASES = ("init", "residuals", "nt_scaling", "assembly", "block_factors",
          "level_products", "kkt_solves", "cr_solve", "cone_step", "rest")
PROF_SLOTS = len(PHASES) + 2

_IN_NAMES = ("AT", "GT", "b_eq", "h", "c", "d_eq", "d_c", "E_st", "scal",
             "warm_x", "warm_y", "warm_z")


def _shapes(K, w, me, mc):
    ins = [(K, 2 * w, me), (K, 2 * w, mc), (K, me), (K, mc), (K, w),
           (K, me), (K, mc), (K, w), (1, 4), (K, w), (K, me), (K, mc)]
    outs = [(K, w), (K, me), (K, mc), (K, mc), (1, 4)]
    return ins, outs


def _load_lib():
    lib = kernels.load("mono_ipm")
    if lib.mono_ipm_launch.argtypes is None:
        c_int, c_double, c_void_p = ctypes.c_int, ctypes.c_double, \
            ctypes.c_void_p
        lib.mono_ipm_workspace_elems.argtypes = [c_int] * 4
        lib.mono_ipm_workspace_elems.restype = ctypes.c_longlong
        lib.mono_ipm_launch.argtypes = (
            [c_int, c_void_p] + [c_int] * 6 + [ctypes.POINTER(c_int)]
            + [c_int] * 4 + [c_double] * 5
            + [ctypes.POINTER(c_void_p), ctypes.POINTER(c_void_p), c_void_p,
               c_void_p])
        lib.mono_ipm_launch.restype = c_int
        lib.mono_ipm_prof_slots.argtypes = []
        lib.mono_ipm_prof_slots.restype = c_int
    return lib


def _mono_cuda(statics, *ins, part="full", prof=None):
    """Launch csrc/mono_ipm.cu on the current stream; raises on anything
    it does not take or on a failed launch. ``prof``, an int64 (B,
    PROF_SLOTS) tensor on the same card, receives the phase counters."""
    code = part_code(part)
    K, w, me, l, soc_sizes, st = statics
    mc = l + sum(soc_sizes)
    AT = ins[0]
    B, dtype, dev = AT.shape[0], AT.dtype, AT.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"mono_ipm takes float32 or float64, not {dtype}")
    in_shapes, out_shapes = _shapes(K, w, me, mc)
    for name, t, shp in zip(_IN_NAMES, ins, in_shapes):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{dtype} on {dev}")
        if tuple(t.shape) != (B,) + shp:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{(B,) + shp}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if prof is not None and (prof.dtype != torch.int64 or prof.device != dev
                             or tuple(prof.shape) != (B, PROF_SLOTS)
                             or not prof.is_contiguous()):
        raise ValueError(f"prof: {prof.dtype} {tuple(prof.shape)} on "
                         f"{prof.device}, expected a contiguous int64 "
                         f"{(B, PROF_SLOTS)} on {dev}")
    lib = _load_lib()
    if lib.mono_ipm_prof_slots() != PROF_SLOTS:
        raise RuntimeError("csrc/mono_ipm.cu counts other phases than "
                           "ipm_mono.PHASES")
    outs = [torch.empty((B,) + s, dtype=dtype, device=dev) for s in out_shapes]
    work = torch.empty(B * lib.mono_ipm_workspace_elems(K, w, me, mc),
                       dtype=dtype, device=dev)
    soc = (ctypes.c_int * max(len(soc_sizes), 1))(*soc_sizes)
    in_ptrs = (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t in ins])
    out_ptrs = (ctypes.c_void_p * len(outs))(*[t.data_ptr() for t in outs])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mono_ipm_launch(
            dtype.itemsize, stream, B, K, w, me, l, len(soc_sizes), soc,
            st.iters, st.refine_steps, int(st.mono_track_best), code,
            st.eps_reg, st.rho_lift, st.eps_feas, st.step_frac,
            st.warm_kappa, in_ptrs, out_ptrs, work.data_ptr(),
            None if prof is None else prof.data_ptr())
    if err != 0:
        raise RuntimeError(f"mono_ipm kernel launch failed: CUDA error {err}")
    kernels.launches["mono_ipm"] += 1
    return tuple(outs)


def mono_solve(statics, *ins, part="full", prof=None):
    """The monolithic solve on ``_prep``'s 12 inputs, or the piece of it
    that ``part`` names: the CUDA kernel for tensors on the card, the
    plain ``_solve_block`` for CPU tensors. ``prof`` (kernel only) takes
    the phase counters: see ``PHASES``."""
    if ins[0].is_cuda:
        return _mono_cuda(statics, *ins, part=part, prof=prof)
    if prof is not None:
        raise ValueError("phase counters exist only in the CUDA kernel")
    return _solve_block(statics, *ins, part=part)


# ---------------------------------------------------------------------------
# prep / post (Ruiz equilibration, scaling, original-space residuals)
# ---------------------------------------------------------------------------


def _prep(prog: StagedProgram, settings: IPMSettings, warm_x, warm_y,
          warm_z, warm_ok):
    """Equilibrate and normalize a batch of programs (everything before
    the cone init of the reference) and pre-scale the warm start."""
    B = prog.A_eq.shape[0]
    (A_eq, G, b_eq, h, c_st), scales, (pres_fac, dres_fac) = \
        _equilibrate(prog, settings)
    E_st, d_eq, d_c, c_scale, b_scale = scales[:5]
    wx = warm_x / (E_st * b_scale[:, None, None])
    wy = warm_y / (d_eq * c_scale[:, None, None])
    wz = warm_z / (d_c * c_scale[:, None, None])
    scal = torch.stack([pres_fac, dres_fac, c_scale * b_scale,
                        warm_ok.to(pres_fac.dtype)], dim=-1).reshape(B, 1, 4)
    ins = (A_eq.transpose(-1, -2), G.transpose(-1, -2), b_eq, h, c_st, d_eq,
           d_c, E_st, scal, wx, wy, wz)
    return tuple(t.contiguous() for t in ins), scales


def solve_staged_ipm_mono(prog: StagedProgram, settings: IPMSettings,
                          warm: StagedSolverResult = None, warm_ok=False):
    """The monolithic solve of a batch of gm == 0 staged programs.
    ``warm_ok`` is a bool or a (B,) bool tensor."""
    statics = (prog.K, prog.w, prog.me, prog.l, tuple(prog.soc_sizes),
               settings)
    B = prog.A_eq.shape[0]
    f = dict(dtype=prog.A_eq.dtype, device=prog.A_eq.device)
    if warm is None:
        wx = torch.zeros((B, prog.K, prog.w), **f)
        wy = torch.zeros((B, prog.K, prog.me), **f)
        wz = torch.zeros((B, prog.K, prog.mc), **f)
    else:
        wx, wy, wz = warm.x_stage, warm.y_stage, warm.z_stage
    wo = torch.as_tensor(warm_ok, device=f["device"]).expand(B)
    ins, scales = _prep(prog, settings, wx, wy, wz, wo)
    x, y, s, z, _ = mono_solve(statics, *ins)
    return _post(prog, x, y, s, z, scales)
