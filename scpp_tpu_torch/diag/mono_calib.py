"""Calibrate the building blocks of the monolithic IPM kernel on the card
(counterpart of ``tools/diag/mono_calib.py``).

    python -m scpp_tpu_torch.diag.mono_calib

Runs the probes A1-G of ``calib.PROBES`` (ITERS = 50 dependent steps in
one launch of a ``csrc/calib.cu`` kernel, the reference's names, shapes
and ``RandomState(i)`` inputs) and prints, for each, the best of 5 by
CUDA events in ms (the host's launch path included, as the reference
timed it), the microseconds a step on the device (the launch replayed in
a CUDA graph, its time in parentheses), then its bound (the larger
of its bytes over 3.35 TB/s and its operations over 67 TFLOP/s fp32), the
plain version's time and the library loop's (or why there is none).
Then the shared-memory probe, the counterpart of the VMEM probe F, at
48 KB, 96 KB, 227 KB and 228 KB.
"""

from __future__ import annotations

import torch

from scpp_tpu_torch.diag import calib

ITERS = 50

# the reference pins full-fp32 products: no TF32 for the library yardsticks
torch.backends.cuda.matmul.allow_tf32 = False


def line(m):
    lib = ("library n/a" if m["library_ms"] is None
           else f"library {m['library_host_ms']:.3f} ms (device "
                f"{m['library_ms']:.4f})")
    return (f"{m['label']:<42} {m['host_ms']:9.3f} ms total  "
            f"{m['us_per_step']:9.2f} us/iter  (device {m['ms']:.4f}"
            f" ms)  bound {m['bound_ms']:.5f} ms ({m['bound_by']})  plain "
            f"{m['plain_ms']:.3f} ms  {lib}")


def run(reps=5):
    """Time each probe and the shared-memory sizes; prints a line each and
    returns ({name: measures}, {bytes: (ok, CUDA error, sum)})."""
    results = {}
    for name in calib.CALIB_NAMES:
        assert calib.PROBES[name].iters == ITERS
        results[name] = calib.measure(name, reps)
        print(line(results[name]), flush=True)
    smem = {}
    for nbytes in calib.SMEM_SIZES:
        smem[nbytes] = calib.smem_probe(nbytes)
        ok, err, _ = smem[nbytes]
        print(f"F  shared memory {nbytes} B ({nbytes / 1024:.0f} KB): "
              + ("OK" if ok else f"FAILED (CUDA error {err})"), flush=True)
    return results, smem


def main():
    print(f"device: {calib.card()}")
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
