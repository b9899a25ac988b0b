"""Single-construct probes on the card (counterpart of
``tools/diag/mono_probe.py``), one per run:

    python -m scpp_tpu_torch.diag.mono_probe <which>

``which`` is one of rank1, bdot, bdot96, reshape88, chol8flat, matvec,
matvecdot, matvecred, transpose, with the reference's shapes, steps (50,
20, or none for reshape88) and ``RandomState(0)`` inputs. Prints the
reference's line (the build and first call as "compile", then the time
of a step on the device, from the launch replayed in a CUDA graph), then
the launch's best of 5 by CUDA events, the bound, the plain version's
time and the library loop's.
"""

from __future__ import annotations

import sys
import time

import torch

from scpp_tpu_torch import kernels
from scpp_tpu_torch.diag import calib

torch.backends.cuda.matmul.allow_tf32 = False


def run(which, reps=5):
    """Build (if needed), call once, then time probe ``which``; prints its
    line and returns the measures with ``compile_s``."""
    pr = calib.PROBES[which]
    t0 = time.perf_counter()
    kernels.build()
    calib.probe(which)
    torch.cuda.synchronize()
    tc = time.perf_counter() - t0
    m = calib.measure(which, reps)
    m["compile_s"] = tc
    lib = ("library n/a" if m["library_ms"] is None
           else f"library {m['library_host_ms']:.3f} ms, device "
                f"{m['library_ms']:.4f} ms")
    print(f"{pr.label:<44} compile {tc:6.1f}s  run "
          f"{m['us_per_step']:9.2f} us  (launch {m['host_ms']:.4f} ms, device "
          f"{m['ms']:.4f} ms, bound {m['bound_ms']:.5f} ms by "
          f"{m['bound_by']}, plain {m['plain_ms']:.3f} ms, {lib})",
          flush=True)
    return m


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if len(argv) != 2 or argv[1] not in calib.PROBE_NAMES:
        print("usage: python -m scpp_tpu_torch.diag.mono_probe <which>, "
              f"which in {', '.join(calib.PROBE_NAMES)}", file=sys.stderr)
        return 2
    print(f"device: {calib.card()}")
    run(argv[1])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
