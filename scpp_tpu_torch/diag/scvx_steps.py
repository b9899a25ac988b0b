"""Count the SCvx steps of bench.py's 64 RocketQuat scenarios, scenario by
scenario, on the paths of the port:

    python -m scpp_tpu_torch.diag.scvx_steps [cuda|cpu] [DTYPE[:PATH] ...]

DTYPE is float32 or float64, PATH main, fused or staged (defaults: cuda,
float32:main); each spec is one solve, in order, in one process. The
configuration is ``flagship_config``, the one ``chip_smoke.py`` drives:
K=30, 30 SCvx iterations, the monolithic IPM at 10 iterations. ``main``
is the unfused dynamics path, ``fused`` sets ``fuse_dynamics=True``,
``staged`` adds the unfused IPM. On the CPU every kernel's plain version
runs. Prints a JSON line a solve: the package it ran (``module``), the
steps of every scenario, the batch's steps (the largest), converged
scenarios, the largest final nonlinear cost and the wall time of the
solve. The batch's steps are the kernels' launches on the path, so two
builds or two dtypes compare by them. Run as a file with another
checkout first on ``PYTHONPATH``, it counts that checkout's steps.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import torch

import scpp_tpu_torch
from scpp_tpu_torch import kernels

B, K = 64, 30


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


def path_config(path):
    cfg = flagship_config()
    if path == "main":
        return cfg
    cfg = dataclasses.replace(cfg, fuse_dynamics=True)
    if path == "fused":
        return cfg
    if path == "staged":
        return dataclasses.replace(
            cfg, solver=cfg.solver.replace(monolith=False))
    raise ValueError(f"unknown path {path!r}")


def count_steps(device="cuda", dtype=torch.float32, path="main"):
    """One solve of the 64 scenarios; returns the JSON line's dict."""
    from scpp_tpu_torch.algos.scvx import solve_scvx
    from scpp_tpu_torch.models import RocketQuat
    t0 = time.perf_counter()
    res = solve_scvx(RocketQuat, dispersed_params(dtype), path_config(path),
                     device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = [int(s) for s in res.steps.tolist()]
    return {"module": scpp_tpu_torch.__file__, "device": device,
            "dtype": str(dtype).replace("torch.", ""), "path": path,
            "batch_steps": max(steps), "converged": int(res.converged.sum()),
            "J_end_max": float(res.nonlinear_cost[:, -1].max()),
            "wall_s": wall, "steps": steps}


def main(argv):
    device = argv[0] if argv else "cuda"
    specs = argv[1:] or ["float32:main"]
    if device == "cuda":
        if not torch.cuda.is_available():
            print("scvx_steps: no CUDA device", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        kernels.build()
    for spec in specs:
        dtype, _, path = spec.partition(":")
        print(json.dumps(count_steps(device, getattr(torch, dtype),
                                     path or "main")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
