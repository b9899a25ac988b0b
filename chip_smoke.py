"""Drive the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

    python3 chip_smoke.py OTHER_CSRC [OTHER_CSRC ...]

Phases, one line each: the card; the build of every kernel from
``scpp_tpu_torch/csrc``; each kernel held against its plain PyTorch
version at the main path's shapes (``cr_solve`` also at budgets of 1
and 2 slots of its shared-memory ring, bit for bit against the full
one); given OTHER_CSRC (another checkout's ``scpp_tpu_torch/csrc``,
e.g. a parent commit's unpacked with ``git archive``), the fused
kernels against that build's (``scpp_tpu_torch.diag.disc_versus``:
registers, spills, code size, outputs and times of both); the main path
itself (bench.py's 64
dispersed RocketQuat K=30 SCvx solves at the flagship configuration,
through ``scpp_tpu_torch.algos.scvx.solve_scvx``) with the launch count
of its kernel; the same solves on the fused dynamics path
(``fuse_dynamics=True``: discretize and resim as one kernel launch each)
with the launch counts of its three kernels; the same solves on the
staged path (``fuse_dynamics=True`` and the unfused staged IPM,
``monolith=False``: every KKT solve one ``cr_solve`` launch); then the
Rocket2D receding-horizon MPC on bench.py's MPC parameters
(``scpp_tpu_torch.algos.mpc.mpc_solve`` and
``drivers.closed_loop.mpc_sim``) with both conic backends: the dense IPM
(``MPCConfig()``, no kernel) and the first-order solver, whose every SOC
projection is one ``soc_project`` launch. Then the calibration slice:
every probe kernel of ``csrc/calib.cu`` against its plain version, the
monolithic IPM's ``part`` hook (init, one and two iterations, the whole
solve) and its phase split by the kernel's clock counters on the main
path's programs, and the calibration scripts
(``scpp_tpu_torch.diag.mono_calib``, ``mono_probe``, ``mono_parts``) with
their launch counts. Then one JSON line of kernel measurements, the
card's name and power limit, and the result line. Any
failure exits non-zero before the result line; without a CUDA device it
exits non-zero at once.
"""

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

# the flagship configuration and bench.py's 64 scenarios
from scpp_tpu_torch.diag.scvx_steps import (B, K, dispersed_params,
                                            flagship_config)

# the reference pins full-fp32 products: no TF32 for matmuls or convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

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
# float32 ceiling of soc_project against the float64 plain projection
# (see check_soc_kernel), about four times the card's first reading,
# 3.68e-8 on the blocks of tests/test_torch_soc_project.py (kernel and
# plain version alike)
SOC_F32_CEILING = 1.5e-7
# bench.py's MPC parameters (bench.py:155-157): the stock Rocket2D with
# this initial state, x_final = 0, constrain_initial_final off
MPC_X_INIT = (5.0, 30.0, 1.0, -2.0, 0.05, 0.0)
# the reference's solved threshold (scpp_tpu/solver/scs.py:89-91)
SOLVED = 1e-4
# fixed ceiling of the float32 mpc_sim's final state on the card against
# the port's float64 CPU run of the same 200 steps (max |difference|
# relative to 1 + max |CPU state|), about four times the card's first
# reading, 7.28e-2: the stock MPC.info weights do not stabilise this
# plant (test_lqr_mpc.py:88-96), so the closed loop drifts and the
# float32 solves' rounding grows along the 200 steps
SIM_CEILING = 0.3
# fixed ceiling of the same runs' state after step 50 (max |difference|),
# about four times the card's reading there, 5.29e-5: the two runs part
# only after it (see PERF.md, section 6)
SIM50_CEILING = 2e-4


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


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


def mono_work(prog, settings, iters, cold, cyclic=False):
    """Bytes the kernel must move (inputs once, outputs once) and the
    floating-point operations of the least work for these inputs, with
    each scenario's own iteration count: the KKT factor and solves as the
    sequential stage recursion (one Wp x Wp block factor per stage). The
    bound uses this count. ``cyclic`` counts the cyclic reduction that
    the kernel runs instead (csrc/mono_ipm_body.cuh): more products, in
    6 chained steps instead of 30 at K=30."""
    w, me, mc = prog.w, prog.me, prog.mc
    Wp = w + me
    esz = prog.A_eq.element_size()
    in_elems = K * (2 * w * (me + mc) + 3 * me + 3 * mc + 3 * w) + 4
    out_elems = K * (w + me + 2 * mc) + 4
    nbytes = B * (in_elems + out_elems) * esz
    fma_gram = K * 3 * w * w * (mc + me)
    if cyclic:
        from scpp_tpu_torch.solver.cr_fused import cr_work
        from scpp_tpu_torch.solver.staged_kkt import level_sizes
        # per level: each odd block's factor and inverse (Wp^3 / 3), its R
        # and Q (O's last me rows are zero: 2 w Wp^2), the next level's
        # blocks (lower triangles of R'SR and Q'SQ, and Q'SR's w rows);
        # the root's factor
        fma_factor = fma_gram + Wp ** 3 / 3
        for n, o in level_sizes(K):
            ne = n - o
            fma_factor += o * (Wp ** 3 / 3 + 2 * w * Wp * Wp)
            fma_factor += (o * Wp * (Wp + 1) / 2 + (ne - 1) * w * (w + 1) / 2
                           + (ne - 1) * w * Wp) * Wp
        fma_raw = cr_work(1, K, Wp, esz)[1] / 2
    else:
        fma_factor = fma_gram + K * (w * w * Wp + Wp ** 3 / 3
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
    from scpp_tpu_torch.diag import calib
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
        graph_ms = calib.graph_ms(lambda: kern(*args), 20)
        plain_ms = cuda_ms(lambda: plain(*args), 2)
        work = disc_work if name == "disc_mono" else resim_work
        nbytes, flops = work(ins32[0], ins32[1], steps, cfg.integrator)
        b_ms, b_by = bound(nbytes, flops)
        measures[name] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                              bound_ms=b_ms, bound_by=b_by,
                              graph_ms=graph_ms)
        print(f"kernel time {tag}: {name} float32 {ms:.4f} ms per launch "
              f"from the host, {graph_ms:.4f} ms in a CUDA graph (B={B} "
              f"K={K}, {steps} {cfg.integrator} steps), plain "
              f"{plain_ms:.1f} ms; bound {b_ms:.5f} ms by {b_by} "
              f"({nbytes / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP): "
              f"{100 * b_ms / ms:.1f}% of it from the host, "
              f"{100 * b_ms / graph_ms:.1f}% in the graph")
        if name == "disc_mono":
            print_disc_parts(tag, args, ms)
        else:
            smem = [disc_mono.resim_smem_bytes(dt, "dopri5", True)
                    for dt in (torch.float32, torch.float64)]
            print(f"resim_mono {tag}: one block a scenario, "
                  f"{disc_mono.resim_threads()} threads and {smem[0]} "
                  f"bytes of shared memory a block (float64 {smem[1]})")
    return ok, measures


# resim_mono against another build, float64: the same sums in the same
# order, so J within this of the other's, relative to 1 + max |J|
VERSUS_F64 = 1e-14


def check_versus(tag, dirs):
    """This checkout's fused kernels against those built from each of
    ``dirs`` (another checkout's ``scpp_tpu_torch/csrc``), by
    ``diag.disc_versus``: registers, spills, blocks an SM, code size,
    outputs and times of both. Gates: disc_mono's outputs bit for bit in
    both types, resim_mono's float64 J within VERSUS_F64; resim_mono's
    float32 J is printed, bit for bit or its distance."""
    from scpp_tpu_torch.diag import disc_versus
    res = disc_versus.versus(dirs)
    ok = True
    for (fn, dtype, case, d), (same, diff, rel) in res["outputs"].items():
        if fn == "disc":
            good = same
        else:
            good = "float64" not in dtype or rel <= VERSUS_F64
        ok &= good
        if not good:
            print(f"versus {tag}: {fn} {dtype} {case} against {d}: "
                  f"{'bit for bit' if same else f'{rel:.3e} relative'} "
                  f"-> FAIL", file=sys.stderr)
    for d in dirs:
        for fn in ("disc", "resim"):
            mine = min(res["graph_ms"][(fn, "this")])
            other = min(res["graph_ms"][(fn, d)])
            print(f"versus {tag}: {fn} float32 in a CUDA graph, this "
                  f"{mine:.4f} ms against {other:.4f} ms ({d}): "
                  f"{100 * (mine / other - 1):+.1f}%")
    print(f"versus {tag}: disc_mono bit for bit and resim_mono float64 "
          f"within {VERSUS_F64:g} -> {'ok' if ok else 'FAIL'}")
    return ok


def print_disc_parts(tag, args, ms_off):
    """disc_mono's part split on one flagship float32 launch (the clock64
    counters of csrc/disc_mono_body.cuh: x chain, Jacobians with r, Y
    recursion, as column 0 of Y sees them), and the launch with the
    counters on."""
    from scpp_tpu_torch.diag.disc_versus import phase_split
    from scpp_tpu_torch.ops import disc_mono
    X = args[1]
    prof = torch.zeros((X.shape[0] * (X.shape[1] - 1), disc_mono.PROF_SLOTS),
                       dtype=torch.int64, device=X.device)
    disc_mono._disc_cuda(*args, prof=prof)
    torch.cuda.synchronize()
    split = phase_split(prof)
    ms_on = cuda_ms(lambda: disc_mono._disc_cuda(*args, prof=prof), 20)
    print(f"disc_mono {tag}: parts, us a block (mean over "
          f"{prof.shape[0]} blocks): " + ", ".join(
              f"{p} {split[p]:.2f}" for p in disc_mono.PHASES)
          + f"; block run by globaltimer mean {split['block'][0]:.2f}, max "
          f"{split['block'][1]:.2f}; clock64 {split['ghz']:.3f} GHz; "
          f"{disc_mono.threads()} threads and "
          f"{disc_mono.smem_bytes(X.dtype, 'dopri5', True)} bytes of shared "
          f"memory a block; launch {ms_off:.4f} ms counters off, "
          f"{ms_on:.4f} ms on")


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
    printed. Then the ring check: on the identity-scaling factor the
    kernel at budgets of 1 slot, 2 slots and the full 227 KB must give
    the same x bit for bit, in float32 and in float64. The time is taken
    by CUDA events over 50 launches from the host, as the staged path
    launches it, and over 50 launches replayed in a CUDA graph (the
    device's time, no host work between launches); both on a factor
    that its previous launch left in L2. Returns (ok, measures)."""
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
            ok &= check_cr_ring(p64, b64, p32, b32)
    p32, b32 = out["p32"], out["b32"]
    from scpp_tpu_torch.diag import calib
    ms = cuda_ms(lambda: cr_fused.cr_solve_single(p32, b32), 50)
    graph_ms = calib.graph_ms(lambda: cr_fused.cr_solve_single(p32, b32), 50)
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
    slots = [cr_fused.ring_slots(K, Wp, cr_fused.SMEM_BUDGET, eb)
             for eb in (4, 8)]
    print(f"kernel time {tag}: cr_solve float32 {ms:.4f} ms per launch "
          f"from the host, {graph_ms:.4f} ms in a CUDA graph (B={B} K={K} "
          f"Wp={Wp}, one right-hand side; ring of {slots[0]} float / "
          f"{slots[1]} double slots in 227 KB), plain {plain_ms:.3f} ms, "
          f"library (batched lu_solve of the assembled {K * Wp}x{K * Wp} "
          f"systems) {library_ms:.3f} ms (its distance from the kernel's x "
          f"{dist(lib_x, k32.double()):.2e}); bound {b_ms:.5f} ms by "
          f"{b_by} ({nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP): "
          f"{100 * b_ms / ms:.1f}% of the bound from the host, "
          f"{100 * b_ms / graph_ms:.1f}% in the graph; half the bound "
          f"(at or below 2 x {b_ms:.5f} = {2 * b_ms:.5f} ms): from the host "
          f"{'met' if ms <= 2 * b_ms else 'not met'}, in the graph "
          f"{'met' if graph_ms <= 2 * b_ms else 'not met'}")
    return ok, dict(max_abs_err=out["max_abs_err"], ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                    graph_ms=graph_ms)


def check_cr_ring(p64, b64, p32, b32):
    """cr_solve at budgets of 1 slot, 2 slots and the full 227 KB on the
    same flagship factor: the ring's depth must not change x, bit for
    bit, in float64 and in float32. Prints each depth's time a launch in
    a CUDA graph."""
    from scpp_tpu_torch.diag import calib
    from scpp_tpu_torch.solver import cr_fused
    ok = True
    for label, packed, b in (("float64", p64, b64), ("float32", p32, b32)):
        _, Kn, Wp = b.shape
        most = cr_fused.ring_slots(Kn, Wp, cr_fused.SMEM_BUDGET,
                                   b.element_size())
        full = cr_fused.cr_solve_single(packed, b)
        same, times = [], {}
        for slots in (1, 2, None):
            budget = (cr_fused.SMEM_BUDGET if slots is None else
                      cr_fused.smem_bytes(Kn, Wp, slots, b.element_size()))
            x = cr_fused.cr_solve_single(packed, b, smem_budget=budget)
            torch.cuda.synchronize()
            if slots is not None:
                same.append(torch.equal(x, full))
            times[slots or most] = calib.graph_ms(
                lambda: cr_fused.cr_solve_single(packed, b, budget), 50)
        good = all(same) and bool(torch.isfinite(full).all())
        print(f"  cr_solve {label} at 1 and 2 ring slots vs the full "
              f"budget ({most} slots): "
              + ", ".join("bit for bit equal" if e else "DIFFER"
                          for e in same) + f" -> {'ok' if good else 'FAIL'}"
              + "; ms a launch in a CUDA graph at "
              + ", ".join(f"{d} slots {t:.4f}" for d, t in times.items()))
        ok &= good
    return ok


MPC_SOC = (7, 13) + (2,) * 7        # the MPC program's cones
MPC_SOC_OFFSET = 94                 # after its 42 + 52 rows
MPC_N = 56                          # its variables: the cone rows start
                                    # at this column of the DR state


def soc_case(rng, Bn, sizes, offset):
    """A (Bn, offset + sum(sizes)) float64 cone vector on the card, with
    the blocks' layout: block c of scenario b strictly inside the cone,
    inside its polar (below), outside both, or z = 0, as (b + c) % 4."""
    from scpp_tpu_torch.ops.soc_project import soc_blocks
    blocks = soc_blocks(offset, tuple(sizes))
    w = rng.standard_normal((Bn, offset + sum(sizes))) * 3.0
    for b in range(Bn):
        for c, (h, q) in enumerate(zip(blocks.heads, blocks.sizes)):
            z = rng.standard_normal(q - 1) * rng.uniform(0.1, 10.0)
            zn = float(np.linalg.norm(z))
            case = (b + c) % 4
            t = (zn * rng.uniform(1.1, 3.0), -zn * rng.uniform(1.1, 3.0),
                 zn * rng.uniform(-0.9, 0.9), rng.uniform(-1.0, 1.0))[case]
            w[b, h] = t
            w[b, h + 1:h + q] = 0.0 if case == 3 else z
    return torch.tensor(w, device="cuda"), blocks


def fresh_launch_ms(fn, src, reps):
    """ms per call of fn on ``reps`` fresh copies of src (a projection
    leaves its blocks in the cone, so a second one would find no work),
    launched back to back from the host, so the host's launch rate
    bounds it for a kernel this short."""
    bufs = [src.clone() for _ in range(reps + 1)]
    fn(bufs[-1])
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for buf in bufs[:reps]:
        fn(buf)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_launch_ms(fn, src, reps):
    """The device time per call of fn: ``reps`` calls on fresh copies of
    src captured in one CUDA graph and replayed, so no host work sits
    between the launches; the smallest of three replays, each on fresh
    copies."""
    bufs = [src.clone() for _ in range(reps)]
    fn(src.clone())
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for buf in bufs:
            fn(buf)
    times = []
    for _ in range(3):
        for buf in bufs:
            buf.copy_(src)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return min(times)


def dr_state(rng, w):
    """The cone vector w (Bn, m) as the first-order solver hands it to
    soc_project_: the column slice [MPC_N, MPC_N + m) of a (Bn, MPC_N +
    m + 1) Douglas-Rachford state, whose other columns are seeded
    values. Returns the state."""
    Bn, m = w.shape
    st = torch.tensor(rng.standard_normal((Bn, MPC_N + m + 1)),
                      dtype=w.dtype, device=w.device)
    st[:, MPC_N:MPC_N + m] = w
    return st


def check_soc_kernel(tag):
    """soc_project, through the solver's wrapper soc_project_ on the
    layout the first-order solver gives it (the cone rows a column slice
    of the Douglas-Rachford state, row stride MPC_N + m + 1), against its
    plain version (ops/soc_project.py: _soc_plain, the reference's math
    once per size group) on the same slice: B=64 x the MPC's nine cones
    at their rows of the program (after 94 free rows), then cones of
    sizes 1-40, every case. The gate is float64 <= 1e-12 relative to
    1 + max |plain| (the two differ in the order of the sums of squares
    and the card's fused multiply-adds); in float32 the kernel must land
    within SOC_F32_CEILING of the float64 plain projection; the state's
    other columns must come back unchanged. Then the time per call at the
    MPC's shapes, B=1 and B=64, of the wrapper and of the plain version,
    both on the device (CUDA graphs) and from the host. Returns (ok,
    measures)."""
    from scpp_tpu_torch.ops import soc_project as sp
    rng = np.random.default_rng(0)
    sizes = MPC_SOC + tuple(range(1, 41))
    w64, blocks = soc_case(rng, B, sizes, MPC_SOC_OFFSET)
    m = w64.shape[1]
    cols = slice(MPC_N, MPC_N + m)

    def dist(a, b):
        return float((a.double() - b).abs().max() / (1 + b.abs().max()))

    st64 = dr_state(rng, w64)
    out, pads_ok = {}, True
    for dt in (torch.float64, torch.float32):
        st = st64.to(dt)
        k, p = st.clone(), st.clone()
        sp.soc_project_(k[:, cols], blocks)
        sp._soc_plain(p[:, cols], blocks)
        for x in (k, p):
            pads_ok &= torch.equal(x[:, :MPC_N], st[:, :MPC_N]) and \
                torch.equal(x[:, cols.stop:], st[:, cols.stop:])
        out[dt] = (k[:, cols], p[:, cols])
    torch.cuda.synchronize()
    (k64, plain64), (k32, plain32) = out[torch.float64], out[torch.float32]
    d64, dk, dp = dist(k64, plain64), dist(k32, plain64), dist(plain32,
                                                               plain64)
    ok = d64 <= 1e-12 and dk <= SOC_F32_CEILING and pads_ok and \
        bool(torch.isfinite(k32).all())
    print(f"  soc_project (wrapper on a column slice, row stride "
          f"{MPC_N + m + 1}): float64 kernel vs plain {d64:.2e} (tolerance "
          f"1e-12); float32 vs float64 plain, kernel / plain: {dk:.2e} / "
          f"{dp:.2e} (kernel ceiling {SOC_F32_CEILING:g}); other columns "
          f"{'unchanged' if pads_ok else 'CHANGED'} -> "
          f"{'ok' if ok else 'FAIL'}")
    mpc_blocks = sp.soc_blocks(MPC_SOC_OFFSET, MPC_SOC)
    m_mpc = MPC_SOC_OFFSET + sum(MPC_SOC)
    mcols = slice(MPC_N, MPC_N + m_mpc)
    times = {}
    for Bn in (1, B):
        w, _ = soc_case(rng, Bn, MPC_SOC, MPC_SOC_OFFSET)
        src = dr_state(rng, w.float())
        launch = lambda st: sp.soc_project_(st[:, mcols],   # noqa: E731
                                            mpc_blocks)
        plain = lambda st: sp._soc_plain(st[:, mcols],      # noqa: E731
                                         mpc_blocks)
        ms = graph_launch_ms(launch, src, 200)
        plain_ms = graph_launch_ms(plain, src, 50)
        eager_ms = fresh_launch_ms(launch, src, 200)
        eager_plain_ms = fresh_launch_ms(plain, src, 50)
        nbytes, flops = sp.soc_work(src[:, mcols], mpc_blocks)
        b_ms, b_by = bound(nbytes, flops)
        times[Bn] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by)
        print(f"kernel time {tag}: soc_project float32 (B={Bn}, the MPC's "
              f"cones {MPC_SOC}, through soc_project_ on the state's column "
              f"slice): {ms:.4f} ms per call on the device, plain "
              f"{plain_ms:.4f} ms (each in one CUDA graph, 200 / 50 "
              f"calls); from the host, back to back, eager: {eager_ms:.4f} "
              f"ms, plain {eager_plain_ms:.4f} ms; bound {b_ms:.2e} ms by "
              f"{b_by} ({nbytes} B, {flops} FLOP, counted on this input); "
              f"library: none (no single PyTorch call projects onto a "
              f"second-order cone)")
    return ok, dict(max_abs_err=float((k32 - plain32).abs().max()),
                    library_ms=None, **times[B])


def aten_ops(fn):
    """The number of aten ops (views included) that one call of fn
    dispatches: the length of the host's op stream."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def mpc_params(Bn, dtype=torch.float32, device="cuda"):
    """bench.py's MPC parameters, Bn copies."""
    from scpp_tpu_torch.models import Rocket2D
    from scpp_tpu_torch.models.base import batch_params
    p = Rocket2D.default_params(dtype, device).replace(
        x_init=torch.tensor(MPC_X_INIT, dtype=dtype, device=device),
        x_final=torch.zeros(6, dtype=dtype, device=device),
        constrain_initial_final=False)
    return batch_params(p, Bn)


def worst_residual(res):
    return torch.maximum(torch.maximum(res.res_pri, res.res_dua),
                         res.res_gap)


def run_mpc_ipm(tag):
    """bench.py's MPC chain on the dense IPM (MPCConfig(), float32, B=1):
    10 chains of 50 data-dependent re-solves, x_i = x (1 + 0.01 i), each
    scaled by 1 + 1e-12 carry where carry is the sum of the previous
    solve's first input; every re-solve timed with CUDA events. Then the
    host per-call time (50 calls, each synchronised) and one batched
    re-solve of x_i, i < 64. Returns (failures, launches, numbers)."""
    from scpp_tpu_torch import kernels
    from scpp_tpu_torch.algos.mpc import mpc_solve
    from scpp_tpu_torch.configs.algorithms import MPCConfig
    from scpp_tpu_torch.models import Rocket2D
    cfg = MPCConfig()
    p1 = mpc_params(1)
    x = p1.x_init
    n_chain, n_rep = 50, 10
    xs = [x * (1.0 + 0.01 * i) for i in range(n_chain)]
    mpc_solve(Rocket2D, p1, x, cfg)
    torch.cuda.synchronize()
    failed = []

    kernels.reset_launches()
    t0 = time.perf_counter()
    ev, chain_ev, worst = [], [], []
    for _ in range(n_rep):
        carry = torch.zeros((), device="cuda")
        c0 = torch.cuda.Event(enable_timing=True)
        c0.record()
        for i in range(n_chain):
            e0, e1 = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            e0.record()
            _, U, res = mpc_solve(Rocket2D, p1, xs[i] * (1.0 + 1e-12 * carry),
                                  cfg)
            e1.record()
            ev.append((e0, e1))
            carry = U[0, 0].sum()
            worst.append(worst_residual(res))
        c1 = torch.cuda.Event(enable_timing=True)
        c1.record()
        chain_ev.append((c0, c1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    per = np.sort([a.elapsed_time(b) for a, b in ev])
    chain_means = [a.elapsed_time(b) / n_chain for a, b in chain_ev]
    worst = torch.cat(worst).cpu().numpy()
    p50, p99 = float(np.percentile(per, 50)), float(np.percentile(per, 99))
    print(f"mpc ipm {tag}: {len(per)} re-solves (B=1, float32, "
          f"MPCConfig(), {n_rep} chains of {n_chain}): per re-solve p50 "
          f"{p50:.2f} ms, p99 {p99:.2f} ms, max {per[-1]:.2f} ms (CUDA "
          f"events); mean per re-solve of each chain "
          + ", ".join(f"{v:.2f}" for v in chain_means)
          + f" ms; {wall:.1f} s wall; worst "
          f"residual {worst.max():.2e} (solved threshold {SOLVED:g}); "
          f"launches " + ", ".join(f"{n} {c}" for n, c in launches.items()))
    if not worst.max() < SOLVED:
        failed.append(f"{int((worst >= SOLVED).sum())} of {len(worst)} "
                      f"re-solves not solved")
    if launches["soc_project"]:
        failed.append(f"soc_project launched {launches['soc_project']} "
                      f"times on the IPM")

    host = []
    for i in range(n_chain):
        t0 = time.perf_counter()
        U = mpc_solve(Rocket2D, p1, xs[i], cfg)[1]
        float(U[0, 0].sum())
        host.append((time.perf_counter() - t0) * 1e3)
    host = np.sort(host)
    n_ops = aten_ops(lambda: mpc_solve(Rocket2D, p1, x, cfg))
    print(f"mpc ipm {tag}: host per call (each synchronised) p50 "
          f"{float(np.percentile(host, 50)):.2f} ms, p99 "
          f"{float(np.percentile(host, 99)):.2f} ms; {n_ops} aten ops per "
          f"re-solve")

    pb = mpc_params(B)
    xb = pb.x_init * (1.0 + 0.01 * torch.arange(B, device="cuda"))[:, None]
    mpc_solve(Rocket2D, pb, xb, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mpc_solve(Rocket2D, pb, xb, cfg)[2]
    solved = int((worst_residual(res) < SOLVED).sum())
    batch_ms = (time.perf_counter() - t0) * 1e3
    print(f"mpc ipm {tag}: one batched re-solve B={B}: {batch_ms:.1f} ms "
          f"(host clock, synchronised), {solved}/{B} solved, worst "
          f"residual {float(worst_residual(res).max()):.2e}")
    if solved != B:
        failed.append(f"batched re-solve: {solved}/{B} solved")
    return failed, launches, dict(p50=p50, p99=p99)


def run_mpc_scs(tag):
    """The first-order backend, MPCConfig(solver=SolverSettings(
    warm_start=True)), float32: a cold solve, then a chain of 10 warm
    re-solves of x_i = x (1 + 0.01 i), at B=1 and at B=64. Gates: finite
    results, and every SOC projection one soc_project launch,
    (iters + 1) per solve. The float32 residuals are printed, not gated
    (the reference's STATUS expects them near 5e-4). Then the float64
    arithmetic: the card's plain Douglas-Rachford solve (aa_memory=0) of
    the MPC program against the port's CPU run of the same solve, 1e-9
    relative. Returns (failures, launches)."""
    from scpp_tpu_torch import kernels
    from scpp_tpu_torch.algos.mpc import mpc_program, mpc_solve
    from scpp_tpu_torch.configs.algorithms import MPCConfig
    from scpp_tpu_torch.models import Rocket2D
    from scpp_tpu_torch.models.base import map_tensors
    from scpp_tpu_torch.solver.scs import SolverSettings, solve_conic
    cfg = MPCConfig(solver=SolverSettings(warm_start=True))
    iters = cfg.solver.iters
    failed, total = [], {}
    for Bn in (1, B):
        pb = mpc_params(Bn)
        scale = 1.0 + 0.01 * torch.arange(Bn, device="cuda")[:, None]
        res = mpc_solve(Rocket2D, pb, pb.x_init * scale, cfg)[2]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        worst, finite = [], []
        for i in range(10):
            X, U, res = mpc_solve(Rocket2D, pb,
                                  pb.x_init * scale * (1.0 + 0.01 * i), cfg,
                                  warm=res)
            worst.append(worst_residual(res))
            finite.append(torch.isfinite(U).all() & torch.isfinite(X).all()
                          & torch.isfinite(res.u).all())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 10
        launches = dict(kernels.launches)
        calls = kernels.solver_calls["soc_projection"]
        if Bn == 1:
            n_ops = aten_ops(lambda: mpc_solve(Rocket2D, pb, pb.x_init, cfg,
                                               warm=res))
            print(f"mpc scs {tag}: {n_ops} aten ops per warm re-solve "
                  f"({n_ops / (iters + 1):.0f} per Douglas-Rachford step)")
        worst = torch.stack(worst).cpu().numpy()
        print(f"mpc scs {tag}: B={Bn}, 10 warm re-solves: {ms:.1f} ms per "
              f"re-solve (host clock, synchronised at the end); float32 "
              f"worst residual per re-solve {worst.max(1).min():.2e}-"
              f"{worst.max():.2e}, {int((worst < SOLVED).sum())}/"
              f"{worst.size} solved (printed only); soc_project launches "
              f"{launches['soc_project']}, solver projections {calls}, "
              f"expected {(iters + 1) * 10}")
        if not bool(torch.stack(finite).all()):
            failed.append(f"B={Bn}: non-finite results")
        if not launches["soc_project"] == calls == (iters + 1) * 10:
            failed.append(f"B={Bn}: soc_project {launches['soc_project']} "
                          f"launches, {calls} projections, expected "
                          f"{(iters + 1) * 10}")
        for n, c in launches.items():
            total[n] = total.get(n, 0) + c

    # float64 arithmetic: the card against the port's CPU run
    p64 = mpc_params(1, torch.float64)
    prog = mpc_program(Rocket2D, p64, p64.x_init, cfg)
    plain_dr = SolverSettings(aa_memory=0)
    card = solve_conic(prog, plain_dr)
    cpu = solve_conic(map_tensors(prog, lambda t: t.cpu()), plain_dr)
    d = max(float((getattr(card, n).cpu() - getattr(cpu, n)).abs().max()
                  / (1 + getattr(cpu, n).abs().max()))
            for n in ("x", "y", "s", "u", "v"))
    print(f"mpc scs {tag}: float64 aa_memory=0 solve, card vs the port's "
          f"CPU run: {d:.2e} (tolerance 1e-9)")
    if not d <= 1e-9:
        failed.append(f"float64 card vs CPU {d:.2e}")
    return failed, total


def run_mpc_sim(tag):
    """mpc_sim with MPCConfig(), B=1, 200 steps of 0.01 s (bench.py:214)
    in float32 on the card, against the port's float64 CPU run: all
    finite, the same active steps, the state after step 50 within
    SIM50_CEILING (the runs are still together there) and the final
    state within SIM_CEILING. The port's float32 CPU run is printed
    beside, against the same float64 run: the witness of how far float32
    rounding alone carries this closed loop. Returns (failures,
    launches)."""
    from scpp_tpu_torch import kernels
    from scpp_tpu_torch.configs.algorithms import MPCConfig
    from scpp_tpu_torch.drivers.closed_loop import mpc_sim
    from scpp_tpu_torch.models import Rocket2D
    cfg, n_steps = MPCConfig(), 200
    kernels.reset_launches()
    t0 = time.perf_counter()
    hist = mpc_sim(Rocket2D, mpc_params(1), cfg, 2.0, 0.01)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    t0 = time.perf_counter()
    ref = mpc_sim(Rocket2D, mpc_params(1, torch.float64, "cpu"), cfg, 2.0,
                  0.01, device="cpu")
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu32 = mpc_sim(Rocket2D, mpc_params(1, torch.float32, "cpu"), cfg, 2.0,
                    0.01, device="cpu")
    cpu32_s = time.perf_counter() - t0
    final, ref_final = hist.X[0, -1].cpu().double(), ref.X[0, -1]
    d = float((final - ref_final).abs().max() / (1 + ref_final.abs().max()))
    d32 = float((cpu32.X[0, -1].double() - ref_final).abs().max()
                / (1 + ref_final.abs().max()))
    c32_final = cpu32.X[0, -1].double()
    d_c32 = float((final - c32_final).abs().max()
                  / (1 + c32_final.abs().max()))
    along = {name: (X.double() - ref.X[0]).abs().amax(-1)
             for name, X in (("card float32", hist.X[0].cpu()),
                             ("CPU float32", cpu32.X[0]))}
    for name, a in along.items():
        print(f"mpc sim {tag}: max |{name} - CPU float64| state after step "
              + ", ".join(f"{k + 1}: {float(a[k]):.2e}"
                          for k in (9, 49, 99, 149, n_steps - 1)))
    d50 = float(along["card float32"][49])
    finite = bool(torch.isfinite(hist.X).all() & torch.isfinite(hist.U).all())
    print(f"mpc sim {tag}: {n_steps} steps of 0.01 s (B=1, float32, "
          f"MPCConfig()): {wall * 1e3 / n_steps:.1f} ms per step ({wall:.1f} "
          f"s wall); active steps {int(hist.steps[0])} (CPU float64 "
          f"{int(ref.steps[0])}, CPU float32 {int(cpu32.steps[0])}), "
          f"reached_end {bool(hist.reached_end[0])}; after step 50 "
          f"{d50:.2e} from the CPU float64 run (ceiling {SIM50_CEILING:g}); "
          f"final state {[round(v, 4) for v in final.tolist()]}, distance "
          f"from the CPU float64 run {d:.2e} (ceiling {SIM_CEILING:g}; the "
          f"CPU float32 run's {d32:.2e}, the card's from the CPU float32 "
          f"run {d_c32:.2e}; CPU runs: float64 {cpu_s:.1f} s, "
          f"float32 {cpu32_s:.1f} s); "
          f"launches " + ", ".join(f"{n} {c}" for n, c in launches.items()))
    failed = []
    if launches["soc_project"]:
        failed.append(f"soc_project launched {launches['soc_project']} "
                      f"times on the IPM")
    if hist.X.shape[1] != n_steps or not finite:
        failed.append("non-finite or short history")
    if int(hist.steps[0]) != int(ref.steps[0]):
        failed.append("active steps differ from the CPU run")
    if not d50 <= SIM50_CEILING:
        failed.append(f"state after step 50 {d50:.2e} from the CPU run")
    if not d <= SIM_CEILING:
        failed.append(f"final state {d:.2e} from the CPU run")
    return failed, launches


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


# float32 tolerances of the probe kernels against their plain versions at
# 2 steps, relative to 1 + max |plain| (tests/test_torch_calib.py holds the
# plain versions against the reference's bodies at the same): the FMA
# loops differ in the order of their sums and the card's fused
# multiply-adds, the two sweeps also in the cancellation of their rank-1
# updates; float64 to 1e-10
PROBE_F32_TOL = {"chol_sweep": 1e-4, "chol8flat": 1e-4}
PROBE_FMA_F32_TOL = 1e-5
PROBE_F64_TOL = 1e-10
PROBE_STEPS = 2


def check_probe_kernels():
    """Every calibration probe through its kernel and its plain version on
    the same inputs, at the probe's full shapes and 2 steps (where every
    body is finite in float32), float64 and float32. Returns (ok, the
    largest float32 |kernel - plain| of each function)."""
    from scpp_tpu_torch.diag import calib
    ok, max_err = True, defaultdict(float)
    for name, pr in calib.PROBES.items():
        dist = {}
        for dtype in (torch.float64, torch.float32):
            ins = calib.probe_inputs(name, "cuda", dtype)
            k = calib._call(name, ins, PROBE_STEPS)
            p = calib._plain_call(name, ins, PROBE_STEPS)
            torch.cuda.synchronize()
            dist[dtype] = float((k.double() - p.double()).abs().max()
                                / (1 + p.double().abs().max()))
            if dtype == torch.float32:
                max_err[pr.fn] = max(max_err[pr.fn],
                                     float((k - p).abs().max()))
                finite = bool(torch.isfinite(k).all())
        tol = PROBE_F32_TOL.get(pr.fn, PROBE_FMA_F32_TOL)
        good = (dist[torch.float64] <= PROBE_F64_TOL
                and dist[torch.float32] <= tol and finite)
        print(f"  calib {name} ({pr.fn}): kernel vs plain float64 "
              f"{dist[torch.float64]:.2e} (tolerance {PROBE_F64_TOL:g}), "
              f"float32 {dist[torch.float32]:.2e} (tolerance {tol:g}) -> "
              f"{'ok' if good else 'FAIL'}")
        ok &= good
    return ok, dict(max_err)


def check_mono_parts(tag, statics, prog64, prog32):
    """Kernel 1's ``part`` hook on the step-0 subproblems of the main path
    (cold): init and iter1 against their plain versions (float64 1e-6 with
    the same counts, float32 within F32_CEILING of the float64 plain
    result, as the whole solve is held), the default launch and
    ``part="full"`` bit for bit alike in float32 (both pass part code -1:
    a check of determinism; that the default launch is the parent's rests
    on the main path's gates and its time), and the time of init, iter1,
    iter2 and full by CUDA events, and the whole solve's phase split by
    the kernel's counters (``diag.mono_parts.profile``). Returns (ok,
    parts)."""
    from scpp_tpu_torch.diag import mono_parts
    from scpp_tpu_torch.solver import ipm_mono
    st = statics[-1]
    ok = True
    ins = {}
    for dt, prog in ((torch.float64, prog64), (torch.float32, prog32)):
        f = dict(dtype=dt, device="cuda")
        ins[dt], _ = ipm_mono._prep(
            prog, st, torch.zeros((B, K, prog.w), **f),
            torch.zeros((B, K, prog.me), **f),
            torch.zeros((B, K, prog.mc), **f),
            torch.zeros(B, dtype=torch.bool, device="cuda"))

    def dist(a, b):
        return max(float((u.double() - v).abs().max() / (1 + v.abs().max()))
                   for u, v in zip(a[:4], b[:4]))

    for part in ("init", "iter1"):
        p64 = ipm_mono._solve_block(statics, *ins[torch.float64], part=part)
        k64 = ipm_mono.mono_solve(statics, *ins[torch.float64], part=part)
        k32 = ipm_mono.mono_solve(statics, *ins[torch.float32], part=part)
        torch.cuda.synchronize()
        d64, d32 = dist(k64, p64), dist(k32, p64)
        same = torch.equal(k64[4][:, 0, 1], p64[4][:, 0, 1])
        finite = all(bool(torch.isfinite(t).all()) for t in k32[:4])
        good = d64 <= 1e-6 and same and d32 <= F32_CEILING and finite
        print(f"  mono_ipm part={part}: float64 kernel vs plain {d64:.2e} "
              f"(tolerance 1e-6), counts {'equal' if same else 'DIFFER'}; "
              f"float32 kernel vs float64 plain {d32:.2e} (ceiling "
              f"{F32_CEILING:g}) -> {'ok' if good else 'FAIL'}")
        ok &= good
    ins32 = ins[torch.float32]
    default = ipm_mono.mono_solve(statics, *ins32)
    full = ipm_mono.mono_solve(statics, *ins32, part="full")
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(default, full))
    print(f"  mono_ipm part=full vs the default launch, float32 (both part "
          f"code -1, a determinism check): "
          f"{'bit for bit equal' if same else 'DIFFER'}")
    ok &= same
    parts = {}
    for part, reps in (("init", 10), ("iter1", 10), ("iter2", 10),
                       ("full", 5)):
        parts[f"{part}_ms"] = cuda_ms(
            lambda: ipm_mono.mono_solve(statics, *ins32, part=part), reps)
    parts["per_iter_ms"] = parts["iter2_ms"] - parts["iter1_ms"]
    iters = default[4][:, 0, 1]
    parts["iterations"] = [int(iters.min()), int(iters.max())]
    print(f"kernel time {tag}: mono_ipm parts, float32, B={B} cold: init "
          f"{parts['init_ms']:.3f} ms, iter1 {parts['iter1_ms']:.3f} ms, "
          f"iter2 {parts['iter2_ms']:.3f} ms, one iteration (iter2 - iter1) "
          f"{parts['per_iter_ms']:.3f} ms, full {parts['full_ms']:.3f} ms "
          f"({parts['iterations'][0]}-{parts['iterations'][1]} iterations "
          f"per scenario)")
    # the whole solve with the kernel's phase counters on (gate: they move
    # the launch by less than 2%, and the phases sum to the blocks' run)
    split, ms_off, ms_on = mono_parts.profile(statics, ins32)
    mono_parts.print_split(f"kernel time {tag}: mono_ipm float32 B={B} "
                           f"cold", split, ms_off, ms_on)
    crs, kkt = split["cr_solve"], split["kkt_solves"]
    print(f"  mono_ipm's KKT solves: kernel 4's solve (phase cr_solve) "
          f"{crs[0]:.3f} ms a launch, {crs[1]:.4f} ms an iteration; the rest "
          f"(phase kkt_solves) {kkt[0]:.3f} ms, {kkt[1]:.4f} ms an "
          f"iteration; the solve's share {100 * crs[0] / (crs[0] + kkt[0]):.1f}"
          f"% of the KKT solves, {100 * crs[0] / split['sum'][0]:.1f}% of the "
          f"launch (the initialization's solves count as init)")
    cost = ms_on / ms_off - 1
    covered = split["sum"][1] / split["block"][1] - 1
    good = abs(cost) < 0.02 and abs(covered) <= 0.01
    print(f"  phase counters: launch {100 * cost:+.2f}% (limit 2%), phases "
          f"sum vs the slowest block's run {100 * covered:+.2f}% -> "
          f"{'ok' if good else 'FAIL'}")
    ok &= good
    parts["phases_ms"] = {name: split[name][0] for name in ipm_mono.PHASES}
    parts["phases_ms_per_iter"] = {name: split[name][1] for name in
                                   ipm_mono.PHASES if name != "init"}
    parts["counters_off_on_ms"] = [ms_off, ms_on]
    return ok, parts


def run_calibration(tag):
    """The calibration slice as its user runs it: the probes of
    ``diag.mono_calib`` (with the shared-memory probe), the nine of
    ``diag.mono_probe`` and the four parts of ``diag.mono_parts``, with
    the launch counts set to 0 just before and read just after. Gates:
    every probe function launched, the parts launched ``mono_ipm``, 48 and
    96 KB of shared memory granted. Returns (failed, probe launches,
    mono_ipm launches, {probe: measures}, {bytes: (ok, error, sum)})."""
    from scpp_tpu_torch import kernels
    from scpp_tpu_torch.diag import calib, mono_calib, mono_parts, mono_probe
    kernels.reset_launches()
    measures, smem = mono_calib.run()
    for which in calib.PROBE_NAMES:
        measures[which] = mono_probe.run(which)
    for part in ("init", "iter1", "iter2", "full"):
        mono_parts.run(part)
    torch.cuda.synchronize()
    launches = {fn: kernels.launches[f"calib_{fn}"]
                for fn in calib.FUNCTIONS}
    mono = kernels.launches["mono_ipm"]
    failed = [f"{fn}: no launch" for fn, c in launches.items() if not c]
    if not mono:
        failed.append("mono_parts launched no mono_ipm")
    for nbytes in calib.SMEM_SIZES[:2]:
        if not smem[nbytes][0]:
            failed.append(f"{nbytes} B of shared memory refused")
    expect = {calib.SMEM_SIZES[2]: True, calib.SMEM_SIZES[3]: False}
    for nbytes, want in expect.items():
        print(f"calibration {tag}: shared memory {nbytes} B "
              f"{'granted' if smem[nbytes][0] else 'refused'}; as documented "
              f"for Hopper (227 KB a block): {smem[nbytes][0] == want}")
    return failed, launches, mono, measures, smem


def print_products(tag, measures):
    """One line per probe of the register-tiled products (C, D, bdot,
    bdot96: bmm; D2: mm2d), float32 at the probe's 50 steps: the kernel's
    device time, the one-call yardstick's and their ratio, the bound and
    the share of it reached, the per-SM floor (``calib.sm_floor_ms``) and
    the share of that."""
    from scpp_tpu_torch.diag import calib
    for name, pr in calib.PROBES.items():
        if pr.fn not in ("bmm", "mm2d"):
            continue
        m = measures[name]
        print(f"kernel time {tag}: calib {name} ({pr.fn}) {m['ms']:.4f} ms; "
              f"library {m['library_ms']:.4f} ms, kernel / library "
              f"{m['ms'] / m['library_ms']:.3f}; bound {m['bound_ms']:.4f} "
              f"ms ({m['bound_by']}), {m['bound_ms'] / m['ms']:.1%} of it "
              f"reached; per-SM floor {m['sm_floor_ms']:.4f} ms, "
              f"{m['sm_floor_ms'] / m['ms']:.1%} of it reached")


def probe_entries(launches, measures, max_err, smem_host_ms, smem_ms,
                  smem_plain_ms, smem_err):
    """One kernels-line entry per probe function: the numbers of its
    first probe (in the order of calib.PROBES) at the top, every probe's
    under ``probes``, with the names of ``calib.measure``: ``ms`` and
    ``library_ms`` are device times (the launches replayed in a CUDA
    graph, as soc_project's); ``host_ms`` and ``library_host_ms`` the best
    of 5 by CUDA events around a call from the host, as the reference
    timed its probes."""
    from scpp_tpu_torch.diag import calib
    keys = ("ms", "host_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_host_ms", "steps")
    entries = []
    for fn in calib.FUNCTIONS:
        if fn == "smem_probe":
            top = dict(ms=smem_ms, host_ms=smem_host_ms,
                       plain_ms=smem_plain_ms,
                       bound_ms=4 / H100_BYTES_PER_S * 1e3, bound_by="bytes",
                       library_ms=None, library_host_ms=None,
                       probe="227 KB",
                       library="no PyTorch call places a tensor in shared "
                               "memory")
            probes = {}
        else:
            probe_names = [k for k, p in calib.PROBES.items() if p.fn == fn]
            probes = {k: {key: measures[k][key] for key in keys}
                      for k in probe_names}
            top = dict(probes[probe_names[0]], probe=probe_names[0],
                       library=measures[probe_names[0]]["library"])
        entries.append(dict(
            name=f"calib_{fn}", route="cuda",
            source="scpp_tpu_torch/csrc/calib.cu",
            replaces=calib.REPLACES[fn], launches=launches[fn],
            max_abs_err=smem_err if fn == "smem_probe" else max_err[fn],
            **top, probes=probes))
    return entries


def main(other_csrc=()):
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
        ins64, k64, p64, rk64, rp64 = solve_both(statics, prog64, warm64)
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
            ms64 = cuda_ms(lambda: ipm_mono._mono_cuda(statics, *ins64), 5)
            plain_ms = cuda_ms(
                lambda: ipm_mono._solve_block(statics, *ins32), 2)
    nbytes, flops = mono_work(prog32, st, iters, cold=True)
    b_ms, b_by = bound(nbytes, flops)
    _, cr_flops = mono_work(prog32, st, iters, cold=True, cyclic=True)
    measures = {"mono_ipm": dict(max_abs_err=max_err, ms=ms,
                                 plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by)}
    print(f"kernel time {tag}: mono_ipm float32 {ms:.3f} ms per launch "
          f"(B={B} cold, IPM iterations per scenario {min(iters):.0f}-"
          f"{max(iters):.0f}; float64 {ms64:.3f} ms), plain "
          f"{plain_ms:.1f} ms; bound "
          f"{b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.2f} MB, "
          f"{flops / 1e9:.2f} GFLOP, the sequential recursion's count); "
          f"the cyclic reduction the kernel runs does {cr_flops / 1e9:.2f} "
          f"GFLOP ({cr_flops / H100_FP32_FLOPS * 1e3:.4f} ms at the fp32 "
          f"peak)")
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
    print(f"kernel vs plain {tag}: soc_project, B={B} x the MPC's nine cones "
          f"and cones of sizes 1-40, every case")
    ok_soc, measures["soc_project"] = check_soc_kernel(tag)
    if not (ok_all and ok_fused and ok_cr and ok_soc):
        print("kernel vs plain: FAILED", file=sys.stderr)
        return 1
    if other_csrc:
        if not check_versus(tag, other_csrc):
            return 1
    else:
        print("versus: no other build given (python3 chip_smoke.py "
              "OTHER_CSRC ...), not run")

    # ---- the main path, the fused dynamics path, the staged path ----
    # Each path's launch counts are set to 0 just before its warm run and
    # read just after; a kernel of another path must not launch.
    params = dispersed_params(torch.float32)
    failed, launches, _, steps = run_path(tag, "main path", cfg, params)
    ok_main = gate_launches("main path", failed, launches, steps,
                            ["mono_ipm"], ["cr_solve", "disc_mono",
                                           "resim_mono", "soc_project"])
    failed, fused_launches, _, steps = run_path(
        tag, "fused path", dataclasses.replace(cfg, fuse_dynamics=True),
        params)
    ok_fused = gate_launches("fused path", failed, fused_launches, steps,
                             ["disc_mono", "resim_mono", "mono_ipm"],
                             ["cr_solve", "soc_project"])
    failed, staged_launches, raw, steps = run_path(tag, "staged path",
                                                   staged, params)
    ok_staged = gate_launches("staged path", failed, staged_launches, steps,
                              ["disc_mono", "resim_mono"],
                              ["mono_ipm", "soc_project"], raw=raw)
    if not (ok_main and ok_fused and ok_staged):
        return 1
    launches.update({n: fused_launches[n] for n in ("disc_mono",
                                                    "resim_mono")})
    launches["cr_solve"] = staged_launches["cr_solve"]

    # ---- the receding-horizon MPC: dense IPM, first-order, closed loop ----
    # Each run's launch counts are set to 0 just before it and read just
    # after; only the first-order solver launches soc_project.
    t_mpc = time.perf_counter()
    ok_mpc = True
    for label, run in (("mpc ipm", run_mpc_ipm), ("mpc scs", run_mpc_scs),
                       ("mpc sim", run_mpc_sim)):
        failed, mpc_launches, *_ = run(tag)
        others = [n for n, c in mpc_launches.items()
                  if c and n != "soc_project"]
        if others:
            failed.append("kernels of the SCvx paths launched: "
                          + ", ".join(others))
        if label == "mpc scs":
            launches["soc_project"] = mpc_launches["soc_project"]
        if failed:
            print(f"{label}: FAILED: " + "; ".join(failed), file=sys.stderr)
            ok_mpc = False
    print(f"mpc {tag}: phase {time.perf_counter() - t_mpc:.1f} s")
    if not ok_mpc:
        return 1

    # ---- the calibration probes and kernel 1's parts ----
    # The probe kernels are held against their plain versions, kernel 1's
    # parts against theirs on the main path's programs (launches not
    # counted); then the calibration scripts run, with the counts set to
    # 0 just before and read just after.
    from scpp_tpu_torch.diag import calib
    t_cal = time.perf_counter()
    print(f"kernel vs plain {tag}: the calibration probes at their shapes, "
          f"{PROBE_STEPS} steps; mono_ipm's parts on the step-0 subproblems")
    ok_probe, probe_err = check_probe_kernels()
    ok_parts, parts = check_mono_parts(tag, statics, prog64, prog32)
    failed, probe_launches, parts_launches, probe_measures, smem = \
        run_calibration(tag)
    print_products(tag, probe_measures)
    big = calib.SMEM_SIZES[2]
    smem_host_ms = cuda_ms(lambda: calib.smem_probe(big, check=False), 20)
    smem_ms = calib.graph_ms(lambda: calib.smem_probe(big, check=False))
    smem_plain_ms = cuda_ms(lambda: calib.smem_probe_plain(big), 20)
    smem_err = abs(smem[big][2] - float(calib.smem_probe_plain(big)))
    print(f"kernel time {tag}: smem_probe {big} B {smem_host_ms:.4f} ms per "
          f"launch from the host, {smem_ms:.4f} ms on the device "
          f"(CUDA graph); plain (a device-memory buffer) "
          f"{smem_plain_ms:.4f} ms")
    build_note = (f", calib.cu nvcc {report['calib'][0]:.1f} s in parallel "
                  f"with the other sources" if "calib" in report else "")
    print(f"calibration {tag}: phase {time.perf_counter() - t_cal:.1f} s"
          + build_note)
    if failed:
        print("calibration: FAILED: " + "; ".join(failed), file=sys.stderr)
    if not (ok_probe and ok_parts) or failed:
        return 1
    measures["mono_ipm"].update(parts=parts, parts_launches=parts_launches)

    sources = {"mono_ipm": ("scpp_tpu_torch/csrc/mono_ipm.cu",
                            "scpp_tpu/solver/ipm_mono.py:385"),
               "disc_mono": ("scpp_tpu_torch/csrc/disc_mono.cu",
                             "scpp_tpu/ops/disc_mono.py:157"),
               "resim_mono": ("scpp_tpu_torch/csrc/disc_mono.cu",
                              "scpp_tpu/ops/disc_mono.py:320"),
               "cr_solve": ("scpp_tpu_torch/csrc/cr_solve.cu",
                            "scpp_tpu/solver/cr_pallas.py:86"),
               "soc_project": ("scpp_tpu_torch/csrc/soc_project.cu",
                               "scpp_tpu/ops/soc_pallas.py:47")}
    # library_ms: no single PyTorch call solves an SOCP, integrates a
    # variational or nonlinear ODE or projects onto a second-order cone;
    # cr_solve's is a batched lu_solve
    for name in ("mono_ipm", "disc_mono", "resim_mono"):
        measures[name]["library_ms"] = None
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=src, replaces=rep,
        launches=launches[name], **measures[name])
        for name, (src, rep) in sources.items()] + probe_entries(
        probe_launches, probe_measures, probe_err, smem_host_ms, smem_ms,
        smem_plain_ms, smem_err)}))
    print(dev)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
