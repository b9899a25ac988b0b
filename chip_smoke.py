"""Drive the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one line each: the card; the build of every kernel from
``scpp_tpu_torch/csrc``; each kernel held against its plain PyTorch
version at the main path's shapes; the main path itself (bench.py's 64
dispersed RocketQuat K=30 SCvx solves at the flagship configuration,
through ``scpp_tpu_torch.algos.scvx.solve_scvx``) with the launch count
of its kernel; the same solves on the fused dynamics path
(``fuse_dynamics=True``: discretize and resim as one kernel launch each)
with the launch counts of its three kernels; the same solves on the
staged path (``fuse_dynamics=True`` and the unfused staged IPM,
``monolith=False``: every KKT solve one ``cr_solve`` launch). Then one
JSON line of kernel measurements, the card's name and power limit, and
the result line. Any failure exits non-zero before the result line;
without a CUDA device it exits non-zero at once.
"""

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from collections import defaultdict

import torch

# the reference pins full-fp32 products: no TF32 for matmuls or convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, K = 64, 30
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12             # fp32 outside the tensor cores, 700 W
F32_CEILING = 1e-2                  # see "kernel vs plain" in main()
# float32 ceilings of the fused kernels (see check_fused_kernels), about
# four times the largest reading on the card at these shapes: 2.78e-7
# (disc_mono; plain 2.70e-7) and 2.95e-6 (resim_mono; plain 2.99e-6,
# the rounding of the 406-term float32 sum of the defect)
DISC_F32_CEILING = 1.1e-6
RESIM_F32_CEILING = 1.2e-5
# float32 ceiling of cr_solve on the identity-scaled KKT systems of the
# step-0 subproblems (see check_cr_kernel), about four times the reading
# on the card: 1.37e-4 for the kernel and the plain version alike (the
# rounding of a float32 factor of systems whose solutions reach 3.5e4)
CR_F32_CEILING = 5.5e-4
# the same at the NT scaling of a mid-solve iterate (the float64 cold
# solve stopped after half its IPM iterations), where the staged path
# still solves in float32: about four times the reading on the card,
# 1.83e-4 for the kernel and the plain version alike
CR_MID_F32_CEILING = 7.5e-4


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def flagship_config():
    from scpp_tpu_torch.configs.algorithms import SCvxConfig
    from scpp_tpu_torch.solver.ipm import IPMSettings
    return SCvxConfig(
        K=K, max_iterations=30, solve_budget=45, change_threshold=1e-3,
        nondimensionalize=True, substeps=6, sim_substeps=8,
        solver=IPMSettings(iters=10, eps_reg=1e-4, eps_feas=1e-4,
                           refine_steps=0, monolith=True))


def dispersed_params(dtype):
    """bench.py's 64 scenarios: the stock params with its dispersed
    initial states (stored in the port, see bench_initial_states)."""
    from scpp_tpu_torch.models import RocketQuat
    from scpp_tpu_torch.models.base import batch_params
    from scpp_tpu_torch.parallel.scenarios import bench_initial_states
    pb = batch_params(RocketQuat.default_params(dtype), B)
    return pb.replace(x_init=bench_initial_states(dtype))


def flagship_programs(cfg, dtype):
    """The step-0 subproblems of the main path, built by the port, with
    the trajectories and parameter vectors they were built around."""
    from scpp_tpu_torch.algos.staged_problems import \
        build_scvx_subproblem_staged
    from scpp_tpu_torch.models import RocketQuat
    from scpp_tpu_torch.models.base import map_tensors
    from scpp_tpu_torch.ops.discretization import multiple_shooting
    p = map_tensors(dispersed_params(dtype), lambda t: t.cuda())
    p = RocketQuat.nondimensionalize(p)
    par = RocketQuat.param_vector(p)
    td = RocketQuat.init_trajectory(p, K, True)
    dd = multiple_shooting(RocketQuat, par, td, substeps=cfg.substeps)
    trust = torch.full((B,), cfg.trust_region, dtype=dtype, device="cuda")
    return build_scvx_subproblem_staged(
        RocketQuat, p, td, dd, trust, cfg.weight_virtual_control,
        RocketQuat.constraint_ref(p, td)), td, par


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def mono_work(prog, settings, iters, cold):
    """Bytes the kernel must move (inputs once, outputs once) and the
    floating-point operations its algorithm does for these inputs, with
    each scenario's own iteration count."""
    w, me, mc = prog.w, prog.me, prog.mc
    Wp = w + me
    esz = prog.A_eq.element_size()
    in_elems = K * (2 * w * (me + mc) + 3 * me + 3 * mc + 3 * w) + 4
    out_elems = K * (w + me + 2 * mc) + 4
    nbytes = B * (in_elems + out_elems) * esz
    fma_factor = K * (3 * w * w * (mc + me) + w * w * Wp + Wp ** 3 / 3
                      + Wp * Wp * w / 2)
    fma_raw = K * (Wp * Wp + 2 * Wp * w)
    fma_a, fma_g = K * me * 2 * w, K * mc * 2 * w
    fma_rmv = K * w * 2 * (me + mc)
    r = settings.refine_steps
    fma_kkt = fma_rmv + (1 + r) * fma_raw + r * (fma_a + fma_g + fma_rmv) \
        + fma_g
    fma_res = fma_rmv + fma_a + fma_g
    per_iter = fma_res + fma_factor + 2 * fma_kkt + 2 * fma_g
    init = (fma_factor + 2 * (fma_rmv + fma_raw + fma_g)) if cold else 0
    fmas = sum(init + it * per_iter + fma_res for it in iters)
    return nbytes, 2.0 * fmas


# Operations of one RocketQuat flow-map evaluation, counted from
# csrc/disc_mono_body.cuh: 108 for the value (rotation matrix 39, mass
# rate 8, velocity rate 21, quaternion rate 25, angular rate 15) and 193
# more for the tangent of one input direction (a product of two dual
# numbers adds 3, a quotient 3, a square root 2, a sum 1, a scaling 1).
FLOW_OPS, TANGENT_OPS = 108, 193


def rk_counts(method):
    """Evaluated stages of a step and the slope terms summed in a step
    (stage inputs plus the step's own combination), as the kernels do
    them: dopri5's last stage has weight 0 and no reader."""
    from scpp_tpu_torch.ops.integrators import TABLEAUS
    c, a_rows, b = TABLEAUS[method]
    stages = len(c) - (1 if b[-1] == 0.0 else 0)
    terms = sum(len(a_rows[i]) for i in range(stages)) + sum(
        1 for w in b if w != 0.0)
    return stages, terms


def disc_work(X, U, substeps, method):
    """Bytes (inputs once, outputs once) and operations of one fused
    discretization at these shapes: per interval and stage the flow map
    and its n + m tangents, r = f - A x - B u, A Y over the ncols columns,
    the R columns and the dt scaling; then the slope sums."""
    Bn, K, n = X.shape
    m = U.shape[-1]
    foh = U.shape[1] == K
    ncols = n + m + (m if foh else 0) + 1
    stages, terms = rk_counts(method)
    per_stage = (FLOW_OPS + (n + m) * TANGENT_OPS + n * (2 * n + 2 * m + 2)
                 + ncols * n * 2 * n + n * (ncols - n)
                 + (n * 2 * m if foh else 0) + n * (ncols + 1))
    per_step = stages * per_stage + terms * 2 * n * (ncols + 1)
    flops = Bn * (K - 1) * substeps * per_step
    esz = X.element_size()
    nbytes = esz * (X.numel() + U.numel() + Bn * 11
                    + Bn * (K - 1) * n * ncols)
    return nbytes, flops


def resim_work(X, U, substeps, method):
    """Bytes and operations of one fused resimulation: per interval and
    stage the flow map, the input interpolation and the dt scaling; the
    slope sums; the defect's |.| sum."""
    Bn, K, n = X.shape
    m = U.shape[-1]
    stages, terms = rk_counts(method)
    per_step = stages * (FLOW_OPS + 2 * m + n) + terms * 2 * n
    flops = Bn * (K - 1) * (substeps * per_step + 3 * n)
    nbytes = X.element_size() * (X.numel() + U.numel() + Bn * 12)
    return nbytes, flops


def unported_work():
    """Bytes and operations of the TPU kernel still to port that would
    run on the main path's programs (B=64, K=30; SOC sizes (5, 3, 3, 4,
    4, 3) per stage), one call, float32: soc_pallas._soc_kernel, the
    projection of every cone of the batch onto the SOC, each cone read
    and written once, about 3q + 4 operations a cone (the norm, the
    three-case select, the scaling)."""
    esz, socs = 4, (5, 3, 3, 4, 4, 3)
    n_cones = B * K
    soc = (esz * 2 * n_cones * sum(socs),
           n_cones * sum(3 * q + 4 for q in socs))
    return {"soc_project (kernel 5)": soc}


def bound(nbytes, flops):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def cast(prog, dtype):
    from scpp_tpu_torch.models.base import map_tensors
    return map_tensors(prog, lambda t: t.to(dtype))


def solve_both(statics, prog, warm):
    """Kernel and plain version on the same prepared inputs; returns the
    raw outputs and the unscaled results of both."""
    from scpp_tpu_torch.solver import ipm_mono
    st = statics[-1]
    f = dict(dtype=prog.A_eq.dtype, device="cuda")
    if warm is None:
        wx = torch.zeros((B, K, prog.w), **f)
        wy = torch.zeros((B, K, prog.me), **f)
        wz = torch.zeros((B, K, prog.mc), **f)
    else:
        wx, wy, wz = (t.to(f["dtype"]) for t in warm)
    ok = torch.full((B,), warm is not None, device="cuda")
    ins, scales = ipm_mono._prep(prog, st, wx, wy, wz, ok)
    k = ipm_mono._mono_cuda(statics, *ins)
    p = ipm_mono._solve_block(statics, *ins)
    torch.cuda.synchronize()
    return ins, k, p, ipm_mono._post(prog, *k[:4], scales), \
        ipm_mono._post(prog, *p[:4], scales)


def rel_diffs(a, b):
    """Max differences of two solve results, relative to 1 + max|b|."""
    out = {}
    for n in ("x_stage", "y_stage", "z_stage"):
        u, v = getattr(a, n).double(), getattr(b, n).double()
        out[n[0]] = float((u - v).abs().max() / (1 + v.abs().max()))
    out["obj"] = float(((a.obj.double() - b.obj.double()).abs()
                        / (1 + b.obj.double().abs())).max())
    return out


def check_fused_kernels(tag, cases):
    """disc_mono and resim_mono against their plain versions at the main
    path's shapes (FOH, dopri5, 6 and 8 steps). ``cases`` maps a name to
    float64 (X, U, t, par) on the card.

    The gate is float64: kernel and plain version differ only in the
    order of the 14-term sums (and the card's fused multiply-adds), so
    they must agree to 1e-9 relative to 1 + max |plain| per output. In
    float32, the main path's dtype, the kernel must land within a fixed
    ceiling of the float64 plain result (DISC_F32_CEILING,
    RESIM_F32_CEILING), about four times the largest reading. Returns
    (ok, measures)."""
    from scpp_tpu_torch.models import RocketQuat
    from scpp_tpu_torch.ops import disc_mono
    cfg = flagship_config()
    specs = {"disc_mono": (disc_mono._disc_cuda, disc_mono._disc_plain,
                           cfg.substeps, DISC_F32_CEILING),
             "resim_mono": (disc_mono._resim_cuda, disc_mono._resim_plain,
                            cfg.sim_substeps, RESIM_F32_CEILING)}

    def outs(r):
        return [o for o in (r if isinstance(r, tuple) else (r,))
                if o is not None]

    def dist(a, b):
        return max(float((u.double() - v).abs().max() / (1 + v.abs().max()))
                   for u, v in zip(outs(a), outs(b)))

    ok, measures = True, {}
    for name, (kern, plain, steps, ceiling) in specs.items():
        max_err = 0.0
        for case, ins64 in cases.items():
            args = (steps, cfg.integrator, True)
            ins32 = [a.float() for a in ins64]
            p64 = plain(RocketQuat, *ins64, *args)
            k64 = kern(RocketQuat, *ins64, *args)
            k32 = kern(RocketQuat, *ins32, *args)
            p32 = plain(RocketQuat, *ins32, *args)
            torch.cuda.synchronize()
            d64, dk, dp = dist(k64, p64), dist(k32, p64), dist(p32, p64)
            finite = all(bool(torch.isfinite(o).all()) for o in outs(k32))
            max_err = max(max_err, max(float((a - b).abs().max())
                                       for a, b in zip(outs(k32), outs(p32))))
            good = d64 <= 1e-9 and dk <= ceiling and finite
            print(f"  {name} {case}: float64 kernel vs plain {d64:.2e} "
                  f"(tolerance 1e-9); float32 vs float64 plain, kernel / "
                  f"plain: {dk:.2e} / {dp:.2e} (kernel ceiling {ceiling:g})"
                  f" -> {'ok' if good else 'FAIL'}")
            ok &= good
        ins32 = [a.float() for a in cases["step 0"]]
        args = (RocketQuat, *ins32, steps, cfg.integrator, True)
        ms = cuda_ms(lambda: kern(*args), 20)
        plain_ms = cuda_ms(lambda: plain(*args), 2)
        work = disc_work if name == "disc_mono" else resim_work
        nbytes, flops = work(ins32[0], ins32[1], steps, cfg.integrator)
        b_ms, b_by = bound(nbytes, flops)
        measures[name] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                              bound_ms=b_ms, bound_by=b_by)
        print(f"kernel time {tag}: {name} float32 {ms:.4f} ms per launch "
              f"(B={B} K={K}, {steps} {cfg.integrator} steps), plain {plain_ms:.1f} "
              f"ms; bound {b_ms:.5f} ms by {b_by} ({nbytes / 1e6:.3f} MB, "
              f"{flops / 1e9:.4f} GFLOP)")
    return ok, measures


def dense_kkt(D, O):
    """The assembled (B, K Wp, K Wp) block-tridiagonal KKT matrices."""
    Bn, Kn, W = D.shape[0], D.shape[1], D.shape[-1]
    M = D.new_zeros((Bn, Kn * W, Kn * W))
    for k in range(Kn):
        M[:, k * W:(k + 1) * W, k * W:(k + 1) * W] = D[:, k]
        if k + 1 < Kn:
            M[:, (k + 1) * W:(k + 2) * W, k * W:(k + 1) * W] = O[:, k]
            M[:, k * W:(k + 1) * W, (k + 1) * W:(k + 2) * W] = \
                O[:, k].transpose(-1, -2)
    return M


def check_cr_kernel(tag, prog64, settings):
    """cr_solve against its plain version (staged_kkt.cr_solve) on the
    KKT systems of the main path's step-0 subproblems (B=64, K=30,
    Wp=48, p=32), through the wrapper the solver calls
    (cr_fused.cr_solve_single), at three scalings: the cold start's
    identity scaling, the NT scaling of the iterate that the float64 cold
    solve of the unfused IPM reaches after half its iterations, and that
    of the iterate it returns; right-hand sides from a seeded generator.

    The gate is float64: kernel and plain version differ only in the
    order of the 48-term sums, so they must agree to 1e-9 relative to
    1 + max |plain|. In float32, the main path's dtype, the kernel on a
    float32 factor must land within a fixed ceiling of the float64 plain
    solution: CR_F32_CEILING at the identity scaling, CR_MID_F32_CEILING
    at the mid-solve iterate. At the late iterate the KKT condition
    number has grown like 1/mu, and a float32 factor there is far from
    the float64 solution for kernel and plain version alike (the solver
    refines against the exact operator), so there float32 is only
    printed. Returns (ok, measures)."""
    from scpp_tpu_torch.solver import cr_fused, ipm_staged
    from scpp_tpu_torch.solver.staged_kkt import cr_factor, cr_solve
    ipm = ipm_staged._StagedIPM(prog64, settings)
    ipm.solve()
    half_iters = settings.iters // 2
    half = ipm_staged._StagedIPM(prog64, settings.replace(iters=half_iters))
    half.solve()
    mid = f"mid-solve iterate ({half_iters} iterations)"
    reps = {"identity scaling": ipm.cones.identity_rep(**ipm.f),
            mid: half.cones.nt_scaling(half.final[2], half.final[3])[0],
            "late iterate": ipm.cones.nt_scaling(ipm.final[2],
                                                 ipm.final[3])[0]}
    ceilings = {"identity scaling": CR_F32_CEILING, mid: CR_MID_F32_CEILING,
                "late iterate": None}
    gen = torch.Generator().manual_seed(0)
    w = prog64.w

    def dist(a, b):
        return float((a.double() - b).abs().max() / (1 + b.abs().max()))

    ok, out = True, {}
    for case, rep in reps.items():
        D, O = ipm.kkt_blocks(rep)
        b64 = torch.randn(D.shape[:2] + D.shape[-1:], generator=gen,
                          dtype=torch.float64).cuda()
        p64 = cr_fused.cr_pack(cr_factor(D, O, w))
        p32 = cr_fused.cr_pack(cr_factor(D.float(), O.float(), w))
        b32 = b64.float()
        plain64 = cr_solve(cr_fused.cr_unpack(p64), b64)
        k64 = cr_fused.cr_solve_single(p64, b64)
        k32 = cr_fused.cr_solve_single(p32, b32)
        plain32 = cr_solve(cr_fused.cr_unpack(p32), b32)
        torch.cuda.synchronize()
        d64, dk, dp = dist(k64, plain64), dist(k32, plain64), \
            dist(plain32, plain64)
        finite = bool(torch.isfinite(k32).all())
        ceiling = ceilings[case]
        good = d64 <= 1e-9 and (ceiling is None or (finite and dk <= ceiling))
        print(f"  cr_solve {case}: float64 kernel vs plain {d64:.2e} "
              f"(tolerance 1e-9); float32 vs float64 plain, kernel / plain: "
              f"{dk:.2e} / {dp:.2e}"
              + ("; printed only" if ceiling is None else
                 f" (kernel ceiling {ceiling:g})")
              + f" -> {'ok' if good else 'FAIL'}")
        ok &= good
        if case == "identity scaling":
            out = dict(p32=p32, b32=b32, D=D.float(), O=O.float(),
                       max_abs_err=float((k32 - plain32).abs().max()))
    p32, b32 = out["p32"], out["b32"]
    ms = cuda_ms(lambda: cr_fused.cr_solve_single(p32, b32), 50)
    plain_ms = cuda_ms(lambda: cr_solve(cr_fused.cr_unpack(p32), b32), 10)
    # library: one batched LU solve against a precomputed dense LU of the
    # same 64 assembled (K Wp) x (K Wp) systems (the factor untimed, as
    # the CR factor is)
    LU, piv = torch.linalg.lu_factor(dense_kkt(out["D"], out["O"]))
    bd = b32.reshape(B, -1, 1)
    lib_x = torch.linalg.lu_solve(LU, piv, bd).reshape(b32.shape)
    library_ms = cuda_ms(lambda: torch.linalg.lu_solve(LU, piv, bd), 10)
    k32 = cr_fused.cr_solve_single(p32, b32)
    torch.cuda.synchronize()
    Wp = b32.shape[-1]
    nbytes, flops = cr_fused.cr_work(B, K, Wp, 4)
    b_ms, b_by = bound(nbytes, flops)
    print(f"kernel time {tag}: cr_solve float32 {ms:.4f} ms per launch "
          f"(B={B} K={K} Wp={Wp}, one right-hand side), plain "
          f"{plain_ms:.3f} ms, library (batched lu_solve of the assembled "
          f"{K * Wp}x{K * Wp} systems) {library_ms:.3f} ms (its distance "
          f"from the kernel's x {dist(lib_x, k32.double()):.2e}); bound "
          f"{b_ms:.5f} ms by {b_by} ({nbytes / 1e6:.2f} MB, "
          f"{flops / 1e6:.1f} MFLOP)")
    return ok, dict(max_abs_err=out["max_abs_err"], ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)


def run_path(tag, label, cfg, params):
    """First call, then a warm call with the CUDA-event phase split and
    the launch counts; gates the warm call's results. Returns (ok,
    launches, raw KKT solves, SCvx steps)."""
    from scpp_tpu_torch import kernels
    from scpp_tpu_torch.algos.scvx import solve_scvx
    from scpp_tpu_torch.models import RocketQuat
    t0 = time.perf_counter()
    solve_scvx(RocketQuat, params, cfg, device="cuda")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    events = defaultdict(list)

    @contextlib.contextmanager
    def phase(name):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        yield
        b.record()
        events[name].append((a, b))

    kernels.reset_launches()
    t0 = time.perf_counter()
    res = solve_scvx(RocketQuat, params, cfg, device="cuda", phase=phase)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    raw = kernels.solver_calls["raw_kkt_solve"]

    conv = int(res.converged.sum())
    J_end = res.nonlinear_cost[:, -1]
    n_steps = int(res.steps.max())
    split = {n: sum(a.elapsed_time(b) for a, b in v) for n, v in
             events.items()}
    total = sum(split.values())
    print(f"{label} {tag}: {conv}/{B} converged; J_end max "
          f"{float(J_end.max()):.4f} mean {float(J_end.mean()):.4f}; "
          f"SCvx steps {n_steps} (per scenario "
          f"{int(res.steps.min())}-{n_steps}); launches "
          + ", ".join(f"{n} {c}" for n, c in launches.items())
          + f"; raw KKT solves {raw}")
    print(f"{label} {tag}: warm solve {wall:.3f} s wall (first "
          f"{first_s:.3f} s) -> {conv / wall:.3f} converged solves/s; "
          f"split (CUDA events, ms over {n_steps} steps): "
          + ", ".join(f"{n} {v:.1f} ({100 * v / total:.1f}%)"
                      for n, v in split.items()))
    failed = []
    if conv != B:
        failed.append(f"{B - conv} scenarios did not converge")
    if not float(J_end.max()) < 0.06:
        failed.append("J_end max outside the basin (0.06)")
    if not bool(torch.isfinite(res.td.X).all()):
        failed.append("non-finite trajectories")
    return failed, launches, raw, n_steps


def gate_launches(label, failed, launches, n_steps, each_step, never,
                  raw=None):
    """Launch gates of one path: the kernels of ``each_step`` at least
    once per SCvx step, those of ``never`` not at all; with ``raw``,
    cr_solve exactly once per raw KKT solve and at least twice a step."""
    for name in each_step:
        if launches[name] < max(n_steps, 1):
            failed.append(f"{name}: {launches[name]} launches in {n_steps} "
                          f"SCvx steps")
    for name in never:
        if launches[name]:
            failed.append(f"{name}: {launches[name]} launches, expected 0")
    if raw is not None:
        if launches["cr_solve"] != raw:
            failed.append(f"cr_solve: {launches['cr_solve']} launches for "
                          f"{raw} raw KKT solves")
        if launches["cr_solve"] < 2 * max(n_steps, 1):
            failed.append(f"cr_solve: {launches['cr_solve']} launches in "
                          f"{n_steps} SCvx steps")
    if failed:
        print(f"{label}: FAILED: " + "; ".join(failed), file=sys.stderr)
    return not failed


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from scpp_tpu_torch import kernels
    from scpp_tpu_torch.solver import ipm_mono

    dev = card()
    tag = f"[{dev}]"
    print(f"device: {dev}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.device_count()} visible")

    # ---- build ----
    t0 = time.perf_counter()
    report = kernels.build(verbose=True)
    build_s = time.perf_counter() - t0
    for name, (sec, log) in report.items():
        usage = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"build {tag}: {name} nvcc {sec:.1f} s; " + " | ".join(usage))
    print(f"build {tag}: all kernels {build_s:.1f} s")

    # ---- kernel vs plain at the main path's shapes ----
    # The gate is float64: the kernel and its plain version run the same
    # algorithm and differ only in summation order (measured ~1e-10 on
    # the card), so they must agree to 1e-6 and give the same converged
    # flags. In float32, the main path's dtype, the kernel must land within
    # F32_CEILING of the float64 solution on the warm solves (warm-started
    # from the float64 cold solution, as the main path's later steps are
    # warm-started): about four times the largest reading there (2.30e-3
    # for the kernel, 2.29e-3 for the plain version, on y). The cold solves
    # end their 10 IPM iterations far from convergence, where float32
    # rounding moves the returned iterate far (both versions land up to
    # 0.19 away), so there float32 is only printed.
    cfg = flagship_config()
    st = cfg.solver
    prog64, td64, par64 = flagship_programs(cfg, torch.float64)
    prog32 = cast(prog64, torch.float32)
    statics = (prog64.K, prog64.w, prog64.me, prog64.l,
               tuple(prog64.soc_sizes), st)
    print(f"kernel vs plain {tag}: mono_ipm B={B} K={K} w={prog64.w} "
          f"me={prog64.me} mc={prog64.mc} soc={prog64.soc_sizes}, step-0 "
          f"subproblems of the main path, cold and warm")
    ok_all, max_err, warm64, warm32 = True, 0.0, None, None
    for case in ("cold", "warm"):
        _, k64, p64, rk64, rp64 = solve_both(statics, prog64, warm64)
        d64 = rel_diffs(rk64, rp64)
        eps = st.eps_feas
        flags = int(((k64[4][:, 0, 0] < eps) != (p64[4][:, 0, 0] < eps))
                    .sum())
        ok64 = max(d64.values()) <= 1e-6 and flags == 0
        ins32, k32, p32, rk32, rp32 = solve_both(statics, prog32, warm32)
        dk, dp = rel_diffs(rk32, rp64), rel_diffs(rp32, rp64)
        ok32 = all(bool(torch.isfinite(t).all()) for t in k32[:4]) and (
            case == "cold" or max(dk.values()) <= F32_CEILING)
        for a, b in zip(k32[:4], p32[:4]):
            max_err = max(max_err, float((a - b).abs().max()))
        print(f"  {case} float64 kernel vs plain: "
              + ", ".join(f"{n} {v:.2e}" for n, v in d64.items())
              + f"; converged flags differing {flags}; tolerance 1e-6 -> "
              f"{'ok' if ok64 else 'FAIL'}")
        print(f"  {case} float32 vs float64 plain, kernel / plain: "
              + ", ".join(f"{n} {dk[n]:.2e} / {dp[n]:.2e}" for n in dk)
              + ("; printed only" if case == "cold" else
                 f"; kernel ceiling {F32_CEILING:g}")
              + f" -> {'ok' if ok32 else 'FAIL'}")
        ok_all &= ok64 and ok32
        warm64 = (rk64.x_stage, rk64.y_stage, rk64.z_stage)
        warm32 = warm64
        if case == "cold":
            # the main path accepts its first subproblem solution outright
            td1 = td64.replace(X=prog64.extract(rk64.x, "X").contiguous(),
                               U=prog64.extract(rk64.x, "U").contiguous())
            iters = k32[4][:, 0, 1].tolist()
            ms = cuda_ms(lambda: ipm_mono._mono_cuda(statics, *ins32), 5)
            plain_ms = cuda_ms(
                lambda: ipm_mono._solve_block(statics, *ins32), 2)
    nbytes, flops = mono_work(prog32, st, iters, cold=True)
    b_ms, b_by = bound(nbytes, flops)
    measures = {"mono_ipm": dict(max_abs_err=max_err, ms=ms,
                                 plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by)}
    print(f"kernel time {tag}: mono_ipm float32 {ms:.3f} ms per launch "
          f"(B={B} cold, IPM iterations per scenario {min(iters):.0f}-"
          f"{max(iters):.0f}), plain {plain_ms:.1f} ms; bound "
          f"{b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.2f} MB, "
          f"{flops / 1e9:.2f} GFLOP)")
    print(f"kernel vs plain {tag}: disc_mono and resim_mono B={B} K={K} "
          f"FOH dopri5, on the step-0 trajectories of the main path and on "
          f"those after its first (accepted) step")
    ok_fused, fused = check_fused_kernels(tag, {
        "step 0": [td64.X, td64.U, td64.t, par64],
        "step 1": [td1.X, td1.U, td1.t, par64]})
    measures.update(fused)
    print(f"kernel vs plain {tag}: cr_solve B={B} K={K} Wp="
          f"{prog64.w + prog64.me} p={prog64.w}, the KKT systems of the "
          f"step-0 subproblems of the main path")
    staged = dataclasses.replace(cfg, fuse_dynamics=True,
                                 solver=cfg.solver.replace(monolith=False))
    ok_cr, measures["cr_solve"] = check_cr_kernel(tag, prog64, staged.solver)
    for name, (nbytes, flops) in unported_work().items():
        b_ms, b_by = bound(nbytes, flops)
        print(f"bound {tag}: {name}, not ported, one call at the main "
              f"path's shapes: {b_ms:.6f} ms by {b_by} ({nbytes / 1e6:.3f} "
              f"MB, {flops / 1e6:.3f} MFLOP)")
    if not (ok_all and ok_fused and ok_cr):
        print("kernel vs plain: FAILED", file=sys.stderr)
        return 1

    # ---- the main path, the fused dynamics path, the staged path ----
    # Each path's launch counts are set to 0 just before its warm run and
    # read just after; a kernel of another path must not launch.
    params = dispersed_params(torch.float32)
    failed, launches, _, steps = run_path(tag, "main path", cfg, params)
    ok_main = gate_launches("main path", failed, launches, steps,
                            ["mono_ipm"], ["cr_solve", "disc_mono",
                                           "resim_mono"])
    failed, fused_launches, _, steps = run_path(
        tag, "fused path", dataclasses.replace(cfg, fuse_dynamics=True),
        params)
    ok_fused = gate_launches("fused path", failed, fused_launches, steps,
                             ["disc_mono", "resim_mono", "mono_ipm"],
                             ["cr_solve"])
    failed, staged_launches, raw, steps = run_path(tag, "staged path",
                                                   staged, params)
    ok_staged = gate_launches("staged path", failed, staged_launches, steps,
                              ["disc_mono", "resim_mono"], ["mono_ipm"],
                              raw=raw)
    if not (ok_main and ok_fused and ok_staged):
        return 1
    launches.update({n: fused_launches[n] for n in ("disc_mono",
                                                    "resim_mono")})
    launches["cr_solve"] = staged_launches["cr_solve"]

    sources = {"mono_ipm": ("scpp_tpu_torch/csrc/mono_ipm.cu",
                            "scpp_tpu/solver/ipm_mono.py:385"),
               "disc_mono": ("scpp_tpu_torch/csrc/disc_mono.cu",
                             "scpp_tpu/ops/disc_mono.py:157"),
               "resim_mono": ("scpp_tpu_torch/csrc/disc_mono.cu",
                              "scpp_tpu/ops/disc_mono.py:320"),
               "cr_solve": ("scpp_tpu_torch/csrc/cr_solve.cu",
                            "scpp_tpu/solver/cr_pallas.py:86")}
    # library_ms: no single PyTorch call solves an SOCP or integrates a
    # variational or nonlinear ODE; cr_solve's is a batched lu_solve
    for name in ("mono_ipm", "disc_mono", "resim_mono"):
        measures[name]["library_ms"] = None
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=src, replaces=rep,
        launches=launches[name], **measures[name])
        for name, (src, rep) in sources.items()]}))
    print(dev)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
