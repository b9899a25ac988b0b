"""Time the monolithic IPM kernel's parts on the card (counterpart of
``tools/diag/mono_parts.py``):

    python -m scpp_tpu_torch.diag.mono_parts [init|iter<N>|full]

The part comes from the argument or from the environment (``PART``,
default ``init``), the settings' iteration cap from ``ITERS`` (default
6), as in the reference: B=16 programs of K=30 stages, w=32, me=16, l=30
and SOCs (5, 3, 3, 4, 4, 3), their 12 kernel inputs drawn by
``np.random.RandomState(0).rand`` in float32. Prints the ``nvcc`` build
time, the first call (host clock, synchronised) and the warm time (best
of 5 by CUDA events).
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


def main(argv=None):
    argv = sys.argv if argv is None else argv
    part = argv[1] if len(argv) > 1 else os.environ.get("PART", "init")
    print(f"device: {calib.card()}")
    run(part, int(os.environ.get("ITERS", "6")))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
