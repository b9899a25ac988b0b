"""scpp_tpu_torch — the PyTorch/CUDA port of ``scpp_tpu``.

Same module layout and names as the JAX package, batch-first: every
tensor carries the scenario batch as its leading dimension (what
``jax.vmap`` made implicit). The JAX package stays the reference; this
package imports neither it nor JAX.

Entry points take an explicit ``device`` and default to ``"cuda"``; the
CPU runs only when the caller asks for it (the tests do).
"""

__version__ = "0.1.0"

from scpp_tpu_torch.trajectory import TrajectoryData, DiscretizationData  # noqa: F401
