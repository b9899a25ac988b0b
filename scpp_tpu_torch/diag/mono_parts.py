"""Time the monolithic IPM kernel's parts on the card (counterpart of
``tools/diag/mono_parts.py``), or split a launch into its phases:

    python -m scpp_tpu_torch.diag.mono_parts [init|iter<N>|full|phases]

The part comes from the argument or from the environment (``PART``,
default ``init``), the settings' iteration cap from ``ITERS`` (default
6), as in the reference: B=16 programs of K=30 stages, w=32, me=16, l=30
and SOCs (5, 3, 3, 4, 4, 3), their 12 kernel inputs drawn by
``np.random.RandomState(0).rand`` in float32. Prints the ``nvcc`` build
time, the first call (host clock, synchronised) and the warm time (best
of 5 by CUDA events). ``phases`` runs the whole solve with the kernel's
clock counters on (``ipm_mono.PHASES``) and prints ms per phase, per
launch and per iteration, averaged over the blocks (:func:`profile`);
``cr_solve`` is kernel 4's solve (``cr::solve``) inside the KKT solves,
``kkt_solves`` the rest of them.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from scpp_tpu_torch import kernels
from scpp_tpu_torch.diag import calib
from scpp_tpu_torch.solver import ipm_mono
from scpp_tpu_torch.solver.ipm import IPMSettings

B, K, w, me, l = 16, 30, 32, 16, 30
socs = (5, 3, 3, 4, 4, 3)
mc = l + sum(socs)


def statics(iters):
    return (K, w, me, l, socs, IPMSettings(iters=iters, eps_reg=1e-4,
                                           eps_feas=1e-4, refine_steps=0))


def inputs(device="cuda"):
    rng = np.random.RandomState(0)
    shapes = [(B, K, 2 * w, me), (B, K, 2 * w, mc), (B, K, me), (B, K, mc),
              (B, K, w), (B, K, me), (B, K, mc), (B, K, w), (B, 1, 4),
              (B, K, w), (B, K, me), (B, K, mc)]
    return [torch.tensor(rng.rand(*s).astype(np.float32), device=device)
            for s in shapes]


def run(part, iters=6, reps=5):
    """Build, first call and warm time of ``mono_solve(..., part=part)``;
    prints them and returns (build_s, first_s, warm_ms)."""
    t0 = time.perf_counter()
    report = kernels.build()
    build_s = time.perf_counter() - t0
    st, ins = statics(iters), inputs()
    t0 = time.perf_counter()
    ipm_mono.mono_solve(st, *ins, part=part)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    warm_ms = calib.best_ms(lambda: ipm_mono.mono_solve(st, *ins, part=part),
                            reps)
    built = (f"nvcc {report['mono_ipm'][0]:.1f} s" if "mono_ipm" in report
             else "built before")
    print(f"PART={part} build {build_s:.1f} s ({built}); first call "
          f"{first_s:.3f} s; warm {warm_ms:.3f} ms (B={B} K={K}, ITERS="
          f"{iters})", flush=True)
    return build_s, first_s, warm_ms


def phase_split(prof, iters):
    """Each block's clock64() cycles per phase (``prof``, (B, PROF_SLOTS))
    in ms, converted by the block's own globaltimer reading of its run,
    and averaged over the blocks: {phase: (ms per launch, ms per
    iteration)} with ``iters`` (B,) the blocks' iteration counts (the
    initialization is per launch only), plus ``"sum"`` (the phases) and
    ``"block"`` (the blocks' whole run by globaltimer), mean and max in
    ms, and ``"ghz"`` (clock64() cycles per globaltimer ns, the mean)."""
    n = len(ipm_mono.PHASES)
    prof = prof.double().cpu()
    ms_per_cycle = prof[:, n + 1] / prof[:, n].clamp_min(1) / 1e6
    ms = prof[:, :n] * ms_per_cycle[:, None]
    its = iters.double().cpu().clamp_min(1)
    split = {}
    for i, name in enumerate(ipm_mono.PHASES):
        per_iter = float("nan") if name == "init" else float(
            (ms[:, i] / its).mean())
        split[name] = (float(ms[:, i].mean()), per_iter)
    split["sum"] = (float(ms.sum(1).mean()), float(ms.sum(1).max()))
    block = prof[:, n + 1] / 1e6
    split["block"] = (float(block.mean()), float(block.max()))
    ghz = float((prof[:, n] / prof[:, n + 1].clamp_min(1)).mean())
    split["ghz"] = (ghz, float("nan"))
    return split


def profile(statics, ins, reps=5):
    """One whole solve with the counters on, and the launch time by CUDA
    events (best of ``reps``) with them off and on. Returns (split,
    ms_off, ms_on) with split from :func:`phase_split`."""
    B = ins[0].shape[0]
    prof = torch.zeros((B, ipm_mono.PROF_SLOTS), dtype=torch.int64,
                       device=ins[0].device)
    out = ipm_mono.mono_solve(statics, *ins, prof=prof)
    torch.cuda.synchronize()
    split = phase_split(prof, out[4][:, 0, 1])
    ms_off = calib.best_ms(lambda: ipm_mono.mono_solve(statics, *ins), reps)
    ms_on = calib.best_ms(lambda: ipm_mono.mono_solve(statics, *ins,
                                                      prof=prof), reps)
    return split, ms_off, ms_on


def print_split(label, split, ms_off, ms_on):
    parts = ", ".join(
        f"{name} {split[name][0]:.3f}" + (
            "" if name == "init" else f" ({split[name][1]:.4f}/it)")
        for name in ipm_mono.PHASES)
    print(f"{label}: phases, ms per launch (per iteration), mean over "
          f"blocks: {parts}; phases sum {split['sum'][0]:.3f} (max block "
          f"{split['sum'][1]:.3f}); block run by globaltimer mean "
          f"{split['block'][0]:.3f}, max {split['block'][1]:.3f}; "
          f"clock64 {split['ghz'][0]:.3f} GHz; launch "
          f"{ms_off:.3f} ms counters off, {ms_on:.3f} ms on "
          f"({100 * (ms_on / ms_off - 1):+.2f}%)", flush=True)


def main(argv=None):
    argv = sys.argv if argv is None else argv
    part = argv[1] if len(argv) > 1 else os.environ.get("PART", "init")
    print(f"device: {calib.card()}")
    iters = int(os.environ.get("ITERS", "6"))
    if part == "phases":
        kernels.build()
        print_split(f"mono_ipm B={B} K={K} ITERS={iters}",
                    *profile(statics(iters), inputs()))
        return 0
    run(part, iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
