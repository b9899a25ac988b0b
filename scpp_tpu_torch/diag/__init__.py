"""Calibration probes of the port's kernels on the card (counterparts of
``tools/diag/mono_calib.py``, ``mono_probe.py`` and ``mono_parts.py``).

``calib`` holds the probe kernels' wrappers and plain versions; the
scripts ``mono_calib``, ``mono_probe`` and ``mono_parts`` time them and
run nothing when imported."""
