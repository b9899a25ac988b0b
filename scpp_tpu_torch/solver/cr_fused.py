"""The single-right-hand-side cyclic-reduction KKT solve of the unfused
staged IPM (counterpart of ``scpp_tpu/solver/cr_pallas.py``).

:func:`cr_pack` stores a :func:`staged_kkt.cr_factor` result once per
factor in one contiguous buffer per batch, (L^-1, R, Q) of every odd
block in level order plus the root's L^-1. :func:`cr_solve_single` then
solves M x = b: on a CUDA tensor it launches the hand-written kernel
``csrc/cr_solve.cu`` (one thread block per scenario, the factor streamed
through a ring of shared-memory slots, as many as ``smem_budget`` bytes
hold: :func:`ring_slots`) or raises; on a CPU tensor it runs
``staged_kkt.cr_solve``, the kernel's plain version, on views of the
same buffer.

The reference chooses between this kernel and XLA ops with
``IPMSettings.kkt_fused`` to save TPU dispatch overhead; on the card
every single-right-hand-side solve launches the kernel, whatever that
flag says.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from scpp_tpu_torch import kernels
from scpp_tpu_torch.solver.staged_kkt import cr_solve, level_sizes

__all__ = ["PackedFactor", "cr_pack", "cr_unpack", "cr_solve_single",
           "cr_work", "smem_bytes", "ring_slots", "SMEM_BUDGET"]

# the shared memory a Hopper block may use (227 KB): the kernel's budget
# unless the caller gives a smaller one
SMEM_BUDGET = 232448


class PackedFactor(NamedTuple):
    blocks: torch.Tensor     # (B, K-1, 3, Wp, Wp): (L^-1, R, Q) per odd block
    root: torch.Tensor       # (B, Wp, Wp)
    p: int                   # primal columns of the signature


def cr_pack(fact) -> PackedFactor:
    """A ``cr_factor`` result as one contiguous buffer (level order)."""
    levels, Linv_root, p = fact
    Bn, Wp = Linv_root.shape[0], Linv_root.shape[-1]
    if levels:
        blocks = torch.cat([torch.stack(lv, dim=2) for lv in levels], dim=1)
    else:
        blocks = Linv_root.new_empty((Bn, 0, 3, Wp, Wp))
    return PackedFactor(blocks.contiguous(), Linv_root.contiguous(), p)


def cr_unpack(packed: PackedFactor):
    """Back to the ``cr_factor`` form, as views of the buffer."""
    K = packed.blocks.shape[1] + 1
    levels, off = [], 0
    for _, o in level_sizes(K):
        lv = packed.blocks[:, off:off + o]
        levels.append((lv[:, :, 0], lv[:, :, 1], lv[:, :, 2]))
        off += o
    return tuple(levels), packed.root, packed.p


def _load_lib():
    lib = kernels.load("cr_solve")
    if lib.cr_solve_launch.argtypes is None:
        c_int, ptr = ctypes.c_int, ctypes.c_void_p
        lib.cr_solve_launch.argtypes = ([c_int, ptr] + [c_int] * 4
                                        + [ctypes.c_longlong] + [ptr] * 4)
        lib.cr_solve_launch.restype = c_int
        lib.cr_solve_smem_bytes.argtypes = [c_int] * 4
        lib.cr_solve_smem_bytes.restype = ctypes.c_longlong
        lib.cr_solve_ring_slots.argtypes = ([c_int] * 2
                                            + [ctypes.c_longlong, c_int])
        lib.cr_solve_ring_slots.restype = c_int
    return lib


def _cr_cuda(packed: PackedFactor, b, smem_budget: int = SMEM_BUDGET):
    """Launch ``cr_solve_kernel`` on the current stream with at most
    ``smem_budget`` bytes of shared memory a block."""
    blocks, root, p = packed
    dtype, dev = b.dtype, b.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cr_solve takes float32 or float64, not {dtype}")
    if b.dim() != 3:
        raise ValueError(f"b: shape {tuple(b.shape)}, expected (B, K, Wp)")
    Bn, K, Wp = b.shape
    shapes = {"blocks": (Bn, K - 1, 3, Wp, Wp), "root": (Bn, Wp, Wp),
              "b": (Bn, K, Wp)}
    for name, a in (("blocks", blocks), ("root", root), ("b", b)):
        if a.device != dev or a.dtype != dtype:
            raise ValueError(f"{name}: {a.dtype} on {a.device}, expected "
                             f"{dtype} on {dev}")
        if tuple(a.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(a.shape)}, expected "
                             f"{shapes[name]}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    x = torch.empty_like(b)
    lib = _load_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cr_solve_launch(dtype.itemsize, stream, Bn, K, Wp, p,
                                  smem_budget, blocks.data_ptr(),
                                  root.data_ptr(),
                                  b.data_ptr(), x.data_ptr())
    if err != 0:
        raise RuntimeError(f"cr_solve kernel launch failed: CUDA error {err}")
    kernels.launches["cr_solve"] += 1
    return x


def cr_solve_single(packed: PackedFactor, b, smem_budget: int = SMEM_BUDGET):
    """x = M^-1 b for b (B, K, Wp): the CUDA kernel for tensors on the
    card (its ring sized by ``smem_budget`` bytes, which must hold one
    slot; the result does not depend on it), ``staged_kkt.cr_solve`` for
    CPU tensors."""
    if b.is_cuda:
        return _cr_cuda(packed, b.contiguous(), smem_budget)
    return cr_solve(cr_unpack(packed), b)


def smem_bytes(K: int, Wp: int, slots: int, elem_bytes: int) -> int:
    """Shared memory of one block of the kernel with a ring of ``slots``
    slots, in bytes (``cr::smem_bytes``, read from the built kernel)."""
    return int(_load_lib().cr_solve_smem_bytes(K, Wp, slots, elem_bytes))


def ring_slots(K: int, Wp: int, budget: int, elem_bytes: int) -> int:
    """The kernel's ring depth in ``budget`` bytes (``cr::ring_slots``,
    read from the built kernel); 0 if not one slot fits, which the kernel
    refuses."""
    return int(_load_lib().cr_solve_ring_slots(K, Wp, budget, elem_bytes))


def cr_work(B: int, K: int, Wp: int, elem_bytes: int):
    """Bytes (each factor block the solve reads, b and x once) and
    floating-point operations of one batched solve: per odd block three
    Wp x Wp products down (L^-1 b, R' S t, Q' S t) and three up (R x,
    Q x, L^-T S rhs), two at the root. On a level with an even number of
    blocks the last odd block's Q is the zero padding of ``cr_factor``:
    the solve neither reads nor applies it, so it is not counted."""
    odd = q_read = 0
    for n, o in level_sizes(K):
        odd += o
        q_read += o - (1 if n % 2 == 0 else 0)
    mats = 2 * odd + q_read + 1
    nbytes = elem_bytes * B * (mats * Wp * Wp + 2 * K * Wp)
    flops = B * (4 * odd + 2 * q_read + 2) * 2 * Wp * Wp
    return nbytes, flops
