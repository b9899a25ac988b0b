"""The fused dynamics kernels of this checkout against those built from
other kernel sources, on the card: their outputs bit for bit (or the
largest difference, absolute and relative to 1 + max |other|), each
kernel's time from the host and in a CUDA graph, in turns, the registers,
spills, resident blocks an SM and code size that ``nvcc -Xptxas -v`` and
``cuobjdump`` give for each build's FOH dopri5 kernels.

    python -m scpp_tpu_torch.diag.disc_versus OTHER_CSRC [OTHER_CSRC ...]

OTHER_CSRC is a directory holding a ``disc_mono.cu`` and the headers it
includes, such as another checkout's ``scpp_tpu_torch/csrc`` unpacked with
``git archive``. Each is built with the kernels' own flags into
``scpp_tpu_torch/_build/versus-<hash>/``, and so is this checkout's
(only ``disc_mono.cu``: nothing else is built). The inputs are bench.py's 64
RocketQuat scenarios at K=30: the main path's step-0 trajectories and the
same perturbed by 1% with a seeded numpy RNG, FOH, dopri5 with 6 substeps
(discretize) and 8 (resim), in float32 and float64. On the card only.
Prints the card and its power limit, then one line per comparison,
build and timing. ``versus(dirs)`` does the same from another script
(``chip_smoke.py``) and returns what it measured.
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
    trajectories; the same perturbed by 1%; and the perturbed ones turned
    and spun (quaternions moved by ~0.1 and renormalized, angular rates
    and lateral thrust and roll torque made nonzero), since the step-0
    trajectories neither turn nor spin, and the rows that read the
    rotation show only there. Seeded numpy draws."""
    from scpp_tpu_torch.diag.scvx_steps import K, dispersed_params
    from scpp_tpu_torch.models import RocketQuat
    p = RocketQuat.nondimensionalize(dispersed_params(torch.float64))
    par = RocketQuat.param_vector(p)
    td = RocketQuat.init_trajectory(p, K, True)
    rng = np.random.default_rng(0)

    def noise(shape, scale):
        return scale * torch.tensor(rng.standard_normal(shape))

    X1 = td.X * (1 + noise(td.X.shape, 1e-2))
    U1 = td.U * (1 + noise(td.U.shape, 1e-2))
    X2, U2 = X1.clone(), U1.clone()
    q = X2[..., 7:11] + noise(X2[..., 7:11].shape, 0.1)
    X2[..., 7:11] = q / q.norm(dim=-1, keepdim=True)
    X2[..., 11:14] = noise(X2[..., 11:14].shape, 1e-3)
    t_ax = U2[..., 2:3].abs()
    U2[..., 0:2] = t_ax * noise(U2[..., 0:2].shape, 0.1)
    U2[..., 3:4] = t_ax * noise(U2[..., 3:4].shape, 1e-3)
    cases = {"step 0": (td.X, td.U, td.t, par),
             "perturbed": (X1, U1, td.t, par),
             "turned": (X2, U2, td.t, par)}
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


def usage(log, threads, resim_threads):
    """{kernel: (registers, spill stores + loads in bytes, blocks an SM by
    the register file, mangled name, threads a block)} from ``-Xptxas -v``
    output, for the FOH dopri5 kernels: discretize at `threads` threads a
    block, resim at `resim_threads`."""
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
        if m and name and "Dopri5, (bool)1" in name:
            regs = int(m.group(1))
            nt = threads if "disc_mono_kernel" in name else resim_threads
            warps = -(-nt // 32)
            per_warp = -(-regs * 32 // 256) * 256
            blocks = min(MAX_BLOCKS, MAX_WARPS // warps,
                         REGS_PER_SM // (per_warp * warps))
            out[name] = (regs, spill, blocks, mangled, nt)
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


def card_line():
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def versus(argv):
    """Build this checkout's kernels and each of ``argv``'s, compare and
    time them (see the module's doc), printing a line each. Returns
    {"outputs": {(fn, dtype, case, other): (bit for bit, largest absolute
    difference, relative to 1 + max |other|)}, "graph_ms" / "host_ms":
    {(fn, label): [ms, ...]}, "ptxas": {label: {kernel: usage}},
    "code_kb": {label: {kernel: KB}}}."""
    calib.card()
    print(f"device: {card_line()}", flush=True)
    res = {"outputs": {}, "graph_ms": {}, "host_ms": {}, "ptxas": {},
           "code_kb": {}}
    builds = {}
    labels = ["this"] + list(argv)
    for label, (lib, log, sizes) in zip(labels,
                                        build([kernels._CSRC] + list(argv))):
        threads = lib.disc_mono_threads() if hasattr(
            lib, "disc_mono_threads") else 32
        # the one-thread-an-interval launcher rounded K - 1 = 29 up to a warp
        resim_nt = lib.resim_mono_threads() if hasattr(
            lib, "resim_mono_threads") else 32
        builds[label] = lib
        res["ptxas"][label], res["code_kb"][label] = {}, {}
        for name, (regs, spill, blocks, mangled, nt) in usage(
                log, threads, resim_nt).items():
            kb = sizes.get(mangled, 0) / 1024
            res["ptxas"][label][name] = (regs, spill, blocks, nt)
            res["code_kb"][label][name] = kb
            print(f"ptxas {label}: {name}: {regs} registers, {spill} bytes "
                  f"spilled, {blocks} blocks an SM by registers ({nt} "
                  f"threads a block); {kb:.1f} KB of code", flush=True)
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
                    rel = max(float((a - b).abs().max()
                                    / (1 + b.abs().max()))
                              for a, b in zip(mine, other))
                    res["outputs"][(fn, str(dtype), case, d)] = (same, diff,
                                                                 rel)
                    print(f"outputs {fn} {dtype} {case}: this vs {d}: "
                          + ("bit for bit" if same else
                             f"largest difference {diff:.3e}, {rel:.3e} "
                             f"relative to 1 + max |{d}|"), flush=True)
    ins = [a.float() for a in cases["step 0"]]
    for fn, steps in (("disc", SUBSTEPS), ("resim", SIM_SUBSTEPS)):
        name = "disc_mono" if fn == "disc" else "resim_mono"
        for d in argv:
            for label in (d, "this", "this", d):
                lib = builds[label]
                host = calib.best_ms(lambda: launch(lib, fn, ins, steps), 20)
                graph = calib.graph_ms(lambda: launch(lib, fn, ins, steps),
                                       20)
                res["host_ms"].setdefault((fn, label), []).append(host)
                res["graph_ms"].setdefault((fn, label), []).append(graph)
                print(f"time {name} float32 B=64 K=30 {label}: {host:.4f} ms "
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
    return res


def main(argv):
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    versus(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
