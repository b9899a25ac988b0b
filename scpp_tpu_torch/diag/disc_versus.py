"""The fused dynamics kernels of this checkout against those built from
other kernel sources, on the card: their outputs bit for bit (or the
largest difference), each discretize kernel's time from the host and in a
CUDA graph, in turns, and the registers, spills and resident blocks an SM
that ``nvcc -Xptxas -v`` gives for each build.

    python -m scpp_tpu_torch.diag.disc_versus OTHER_CSRC [OTHER_CSRC ...]

OTHER_CSRC is a directory holding a ``disc_mono.cu`` and the headers it
includes, such as another checkout's ``scpp_tpu_torch/csrc`` unpacked with
``git archive``. Each is built with the kernels' own flags into
``scpp_tpu_torch/_build/versus-<hash>/``, and so is this checkout's
(only ``disc_mono.cu``: nothing else is built). The inputs are bench.py's 64
RocketQuat scenarios at K=30: the main path's step-0 trajectories and the
same perturbed by 1% with a seeded numpy RNG, FOH, dopri5 with 6 substeps
(discretize) and 8 (resim), in float32 and float64. On the card only.
Prints the card, then one line per comparison, build and timing.
"""

from __future__ import annotations

import ctypes
import hashlib
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from scpp_tpu_torch import kernels
from scpp_tpu_torch.diag import calib
from scpp_tpu_torch.ops import disc_mono

SUBSTEPS, SIM_SUBSTEPS, METHOD = 6, 8, "dopri5"
REGS_PER_SM, MAX_WARPS, MAX_BLOCKS = 65536, 64, 32


def flagship_cases(device="cuda"):
    """{name: float64 (X, U, t, par)}: the 64 scenarios' step-0
    trajectories, and the same perturbed by 1%."""
    from scpp_tpu_torch.diag.scvx_steps import K, dispersed_params
    from scpp_tpu_torch.models import RocketQuat
    p = RocketQuat.nondimensionalize(dispersed_params(torch.float64))
    par = RocketQuat.param_vector(p)
    td = RocketQuat.init_trajectory(p, K, True)
    rng = np.random.default_rng(0)
    X1 = td.X * (1 + 1e-2 * torch.tensor(rng.standard_normal(td.X.shape)))
    U1 = td.U * (1 + 1e-2 * torch.tensor(rng.standard_normal(td.U.shape)))
    cases = {"step 0": (td.X, td.U, td.t, par), "perturbed": (X1, U1, td.t,
                                                               par)}
    return {k: [a.contiguous().to(device) for a in v]
            for k, v in cases.items()}


def build(dirs):
    """Build each directory's ``disc_mono.cu``, all at once; returns
    [(library, ptxas lines, {kernel: bytes of code})] in order."""
    procs = []
    for csrc in map(Path, dirs):
        digest = hashlib.sha256()
        for p in [csrc / "disc_mono.cu"] + sorted(csrc.glob("*.cuh")):
            digest.update(p.read_bytes())
        out = kernels._BUILD / f"versus-{digest.hexdigest()[:16]}"
        out.mkdir(parents=True, exist_ok=True)
        lib = out / "libdisc_mono.so"
        procs.append((lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(lib), str(csrc / "disc_mono.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    built = []
    for lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib}:\n{log}")
        built.append((ctypes.CDLL(str(lib)), log.splitlines(),
                      code_bytes(lib)))
    return built


def code_bytes(lib):
    """{mangled kernel name: bytes of SASS} of a built library, from
    ``cuobjdump -sass`` (16 bytes an instruction)."""
    cuobjdump = Path(kernels._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                         capture_output=True, text=True).stdout
    sizes, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            sizes[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s", line):
            sizes[name] += 16
    return sizes


def usage(log, threads):
    """{kernel: (registers, spill stores + loads in bytes, blocks an SM by
    the register file, mangled name)} from ``-Xptxas -v`` output, for the
    discretize kernel of `threads` threads a block and the resim kernel
    (256)."""
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    out, name, mangled, spill = {}, None, None, 0
    for line in log:
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w]+)'?", line)
        if m:
            name = mangled = m.group(1)
            if filt:
                name = subprocess.run([filt, name], capture_output=True,
                                      text=True).stdout.strip()
                name = re.sub(r"\([^()]*\)$", "", re.sub(
                    r"^void |\(anonymous namespace\)::|<unnamed>::", "",
                    name))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs = int(m.group(1))
            nt = threads if "disc_mono_kernel" in name else 256
            warps = nt // 32
            per_warp = -(-regs * 32 // 256) * 256
            blocks = min(MAX_BLOCKS, MAX_WARPS // warps,
                         REGS_PER_SM // (per_warp * warps))
            out[name] = (regs, spill, blocks, mangled)
    return out


def launch(lib, fn, ins, steps, prof=None):
    """Run a build's discretize (``fn`` "disc") or resim kernel on the
    current stream; a launcher that predates the counter argument takes
    none."""
    X, U, t, par = ins
    Bn, K, n = X.shape
    m = U.shape[-1]
    c_int, ptr = ctypes.c_int, ctypes.c_void_p
    head = [X.element_size(), 0, disc_mono._METHODS.index(METHOD), 1]
    dims = [Bn, K, U.shape[1], steps]
    stream = torch.cuda.current_stream().cuda_stream
    if fn == "disc":
        outs = [X.new_empty(s) for s in ((Bn, K - 1, n, n),
                                         (Bn, K - 1, n, m),
                                         (Bn, K - 1, n, m), (Bn, K - 1, n))]
        extra = [None if prof is None else prof.data_ptr()] if hasattr(
            lib, "disc_mono_prof_slots") else []
        f = lib.disc_mono_launch
    else:
        outs, extra = [X.new_empty((Bn,))], []
        f = lib.resim_mono_launch
    f.argtypes = [c_int] * 4 + [ptr] + [c_int] * 4 + [ptr] * (
        4 + len(outs) + len(extra))
    f.restype = c_int
    err = f(*head, stream, *dims, *[a.data_ptr() for a in ins],
            *[o.data_ptr() for o in outs], *extra)
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return tuple(outs)


def phase_split(prof):
    """Each block's clock64() cycles per phase (``prof``, (N, PROF_SLOTS))
    in microseconds, converted by the block's own globaltimer reading of
    its run, and averaged over the blocks: {phase: us}, plus ``"block"``
    (the blocks' whole run by globaltimer, mean and max, us) and ``"ghz"``
    (clock64() cycles per globaltimer ns, the mean)."""
    n = len(disc_mono.PHASES)
    prof = prof.double().cpu()
    us_per_cycle = prof[:, n + 1] / prof[:, n].clamp_min(1) / 1e3
    us = prof[:, :n] * us_per_cycle[:, None]
    split = {name: float(us[:, i].mean())
             for i, name in enumerate(disc_mono.PHASES)}
    block = prof[:, n + 1] / 1e3
    split["block"] = (float(block.mean()), float(block.max()))
    split["ghz"] = float((prof[:, n] / prof[:, n + 1].clamp_min(1)).mean())
    return split


def profile(lib, ins, steps):
    """One launch of this build with the counters on; the split of
    ``phase_split``."""
    X = ins[0]
    prof = torch.zeros((X.shape[0] * (X.shape[1] - 1), disc_mono.PROF_SLOTS),
                       dtype=torch.int64, device=X.device)
    launch(lib, "disc", ins, steps, prof=prof)
    torch.cuda.synchronize()
    return phase_split(prof)


def main(argv):
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(f"device: {calib.card()}", flush=True)
    builds = {}
    labels = ["this"] + argv
    for label, (lib, log, sizes) in zip(labels,
                                        build([kernels._CSRC] + argv)):
        threads = lib.disc_mono_threads() if hasattr(
            lib, "disc_mono_threads") else 32
        builds[label] = lib
        for name, (regs, spill, blocks, mangled) in usage(
                log, threads).items():
            print(f"ptxas {label}: {name}: {regs} registers, {spill} bytes "
                  f"spilled, {blocks} blocks an SM by registers "
                  f"({threads if 'disc_mono' in name else 256} threads a "
                  f"block); {sizes.get(mangled, 0) / 1024:.1f} KB of code",
                  flush=True)
    here = builds["this"]
    cases = flagship_cases()
    for dtype in (torch.float32, torch.float64):
        for case, ins64 in cases.items():
            ins = [a.to(dtype) for a in ins64]
            for fn, steps in (("disc", SUBSTEPS), ("resim", SIM_SUBSTEPS)):
                mine = launch(here, fn, ins, steps)
                for d in argv:
                    other = launch(builds[d], fn, ins, steps)
                    torch.cuda.synchronize()
                    same = all(torch.equal(a, b) for a, b in zip(mine, other))
                    diff = max(float((a - b).abs().max())
                               for a, b in zip(mine, other))
                    print(f"outputs {fn} {dtype} {case}: this vs {d}: "
                          + ("bit for bit" if same else
                             f"largest difference {diff:.3e}"), flush=True)
    ins = [a.float() for a in cases["step 0"]]
    for d in argv:
        for label in (d, "this", "this", d):
            lib = builds[label]
            host = calib.best_ms(lambda: launch(lib, "disc", ins, SUBSTEPS),
                                 20)
            graph = calib.graph_ms(
                lambda: launch(lib, "disc", ins, SUBSTEPS), 20)
            print(f"time disc_mono float32 B=64 K=30 {label}: {host:.4f} ms "
                  f"from the host (best of 20), {graph:.4f} ms in a CUDA "
                  f"graph", flush=True)
    for label, lib in builds.items():
        if not hasattr(lib, "disc_mono_prof_slots"):
            continue
        for dtype in (torch.float32, torch.float64):
            split = profile(lib, [a.to(dtype) for a in cases["step 0"]],
                            SUBSTEPS)
            print(f"phases disc_mono {label} {dtype}: " + ", ".join(
                f"{p} {split[p]:.2f}" for p in disc_mono.PHASES)
                + f" us a block (mean); block run mean "
                f"{split['block'][0]:.2f}, max {split['block'][1]:.2f} us; "
                f"clock64 {split['ghz']:.3f} GHz", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
