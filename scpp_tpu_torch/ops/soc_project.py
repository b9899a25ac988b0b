"""Batched second-order-cone projection (counterpart of
``scpp_tpu/ops/soc_pallas.py``).

The per-iteration cone projection of the first-order conic solver
(``solver/scs.py``) projects the stacked SOC blocks (t, z) of a batch of
cone vectors onto ||z|| <= t. :func:`soc_project_` does it in place: on a
CUDA tensor it launches the hand-written kernel ``csrc/soc_project.cu``
(one launch for every block of every scenario) or raises; on a CPU tensor
it runs :func:`soc_project_blocks_reference`, the kernel's plain version,
once per size group as the reference does. Nothing falls back.

The block layout is a :class:`SocBlocks`: the static (head, size) pairs
of one program structure, with its int32 table copied to each device
once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from scpp_tpu_torch import kernels

__all__ = ["SocBlocks", "soc_blocks", "soc_project_",
           "soc_project_blocks_reference", "soc_work"]


def soc_project_blocks_reference(blocks):
    """Project rows (..., q) = (t, z_1..z_{q-1}) onto the SOC (the math
    of ``soc_pallas.py:33-44`` and of its kernel)."""
    t = blocks[..., 0]
    z = blocks[..., 1:]
    zn = torch.linalg.vector_norm(z, dim=-1)
    safe = torch.clamp_min(zn, 1e-30)
    inside = zn <= t
    below = zn <= -t
    a = 0.5 * (t + zn)
    zero = torch.zeros_like(t)
    t_new = torch.where(inside, t, torch.where(below, zero, a))
    z_scale = torch.where(inside, torch.ones_like(t),
                          torch.where(below, zero, a / safe))
    return torch.cat([t_new[..., None], z * z_scale[..., None]], dim=-1)


class SocBlocks:
    """The SOC blocks of a cone vector: ``heads[i]`` is the first row of
    block i and ``sizes[i]`` its size, in program order."""

    def __init__(self, heads: Tuple[int, ...], sizes: Tuple[int, ...]):
        self.heads = tuple(int(h) for h in heads)
        self.sizes = tuple(int(q) for q in sizes)
        groups: Dict[int, list] = {}
        for h, q in zip(self.heads, self.sizes):
            groups.setdefault(q, []).append(h)
        # size -> (G, q) row indices, for the plain version
        self.groups = {q: np.asarray(hs)[:, None] + np.arange(q)[None, :]
                       for q, hs in groups.items()}
        self._on = {}

    def __len__(self):
        return len(self.heads)

    def table(self, device) -> torch.Tensor:
        """(2, n_cones) int32 (heads, sizes) on ``device``, copied once."""
        key = str(device)
        if key not in self._on:
            self._on[key] = torch.tensor([self.heads, self.sizes],
                                         dtype=torch.int32, device=device)
        return self._on[key]

    def index(self, device) -> Dict[int, torch.Tensor]:
        key = ("index", str(device))
        if key not in self._on:
            self._on[key] = {q: torch.as_tensor(idx, device=device)
                             for q, idx in self.groups.items()}
        return self._on[key]


@functools.lru_cache(maxsize=64)
def soc_blocks(offset: int, soc_sizes: Tuple[int, ...]) -> SocBlocks:
    """The blocks of SOC sizes laid out from row ``offset`` on; one object
    (and one device table) per program structure."""
    heads, off = [], offset
    for q in soc_sizes:
        heads.append(off)
        off += q
    return SocBlocks(tuple(heads), tuple(soc_sizes))


def _load_lib():
    lib = kernels.load("soc_project")
    if lib.soc_project_launch.argtypes is None:
        c_int, ptr = ctypes.c_int, ctypes.c_void_p
        lib.soc_project_launch.argtypes = [c_int, ptr, c_int, c_int,
                                           ctypes.c_longlong, ptr, ptr, ptr]
        lib.soc_project_launch.restype = c_int
    return lib


def _soc_cuda(w, blocks: SocBlocks):
    """Launch ``soc_project_kernel`` on the current stream, in place."""
    if w.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"soc_project takes float32 or float64, not {w.dtype}")
    if w.dim() != 2 or w.stride(1) != 1:
        raise ValueError(f"w: shape {tuple(w.shape)} strides {w.stride()}, "
                         "expected (B, m) with unit column stride")
    Bn, m = w.shape
    if max(h + q for h, q in zip(blocks.heads, blocks.sizes)) > m:
        raise ValueError(f"SOC blocks reach past the {m} columns of w")
    table = blocks.table(w.device)
    lib = _load_lib()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.soc_project_launch(w.element_size(), stream, Bn,
                                     len(blocks), w.stride(0),
                                     table[0].data_ptr(), table[1].data_ptr(),
                                     w.data_ptr())
    if err != 0:
        raise RuntimeError(f"soc_project kernel launch failed: CUDA error "
                           f"{err}")
    kernels.launches["soc_project"] += 1
    return w


def _soc_plain(w, blocks: SocBlocks):
    for q, idx in blocks.index(w.device).items():
        w[:, idx] = soc_project_blocks_reference(w[:, idx])
    return w


def soc_project_(w, blocks: SocBlocks):
    """Project the SOC blocks of the rows of ``w`` (B, m) in place: the
    CUDA kernel for tensors on the card, the plain version for CPU
    tensors. ``w`` may be a column slice of a wider tensor."""
    if not len(blocks):
        return w
    if w.is_cuda:
        return _soc_cuda(w, blocks)
    return _soc_plain(w, blocks)


def soc_work(w, blocks: SocBlocks):
    """Bytes and operations of one projection of the SOC blocks of ``w``
    (B, m), counted on its data, as the kernel does the work: every SOC
    value is read once, and only the blocks outside their cone are
    written (a block inside is left as it is). Every block of size q
    costs the q - 1 squares and q - 2 sums of its norm, a square root and
    the test (2 q - 1); a block outside also costs the second test, the
    half-sum (2), the safe norm, the scale and the q - 1 products (q + 4)."""
    nbytes = flops = 0
    for q, idx in blocks.index(w.device).items():
        blk = w[:, idx]
        n_all = blk.shape[0] * blk.shape[1]
        inside = torch.linalg.vector_norm(blk[..., 1:], dim=-1) <= blk[..., 0]
        n_out = n_all - int(inside.sum())
        nbytes += w.element_size() * q * (n_all + n_out)
        flops += (2 * q - 1) * n_all + (q + 4) * n_out
    return nbytes, flops
