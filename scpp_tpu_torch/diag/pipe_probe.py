"""What limits the calibration products on one SM of the card: the
shared-memory pipe's cycles per warp load (4-, 8- and 16-byte loads, each
lane at its own address or all at one) and the rate of warp FMAs for the
register tiles the products use (``csrc/calib_body.cuh``); and the
instruction caches: cycles per warp instruction for four warps looping
over 4 to 64 KB of straight-line code, one copy shared or each warp its
own (what sizes ``csrc/disc_mono_body.cuh``'s code).

    python -m scpp_tpu_torch.diag.pipe_probe

Builds ``diag/pipe_probe.cu`` with ``nvcc`` into ``scpp_tpu_torch/_build``
and runs it; on the card only (it exits non-zero without one). Prints the
card, then one line per case.
"""

from __future__ import annotations

import subprocess
from pathlib import Path

from scpp_tpu_torch import kernels
from scpp_tpu_torch.diag import calib

SOURCE = Path(__file__).with_suffix(".cu")


def run():
    """Build and run the probe; returns its output lines."""
    out = kernels._BUILD / "pipe_probe"
    out.parent.mkdir(parents=True, exist_ok=True)
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                       "-fPIC")]
    subprocess.run([kernels._nvcc(), *flags, "-o", str(out), str(SOURCE)],
                   check=True)
    res = subprocess.run([str(out)], capture_output=True, text=True,
                         check=True)
    return res.stdout.splitlines()


def main():
    print(f"device: {calib.card()}")
    for line in run():
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
