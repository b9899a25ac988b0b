"""Fused discretization and resimulation (counterpart of
``scpp_tpu/ops/disc_mono.py``), batch-first.

``multiple_shooting_fused`` and ``nonlinear_defect_cost_fused`` compute
what the reference's Pallas kernels ``_disc_kernel`` and ``_resim_kernel``
compute: one flat batch of N = B (K-1) intervals, integrated with
fixed-step RK in normalized time tau in [0, 1] (h = 1 / substeps) with
the right-hand side scaled by each interval's dt. They agree with the
unfused ``multiple_shooting`` and ``nonlinear_defect_cost``, which
integrate in physical time, up to reassociation.

On CUDA tensors each launches its hand-written kernel
(``csrc/disc_mono.cu``) or raises; on CPU tensors it runs the plain
version (``_disc_plain``, ``_resim_plain``). Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from scpp_tpu_torch import kernels
from scpp_tpu_torch.models.base import flow_with_jacobians
from scpp_tpu_torch.ops.integrators import integrate_fixed
from scpp_tpu_torch.trajectory import DiscretizationData, TrajectoryData

__all__ = ["multiple_shooting_fused", "nonlinear_defect_cost_fused"]

_METHODS = ("rk4", "dopri5")     # the kernels' method ids
# The discretize kernel's phase counters (csrc/disc_mono_body.cuh, enum
# DiscPhase), in order; a (B (K-1), PROF_SLOTS) int64 buffer holds each
# block's clock64() cycles per phase, then its whole run in cycles and in
# globaltimer ns.
PHASES = ("x_chain", "jacobians", "y_recursion")
PROF_SLOTS = len(PHASES) + 2


def _flat(X, U, t, par, foh):
    """The flat interval batch: x0, u0, u1 (N, .), par (N, p), dt (N, 1)."""
    Bn, K, n = X.shape
    m = U.shape[-1]
    N = Bn * (K - 1)
    x0 = X[:, :-1].reshape(N, n)
    u0 = U[:, :K - 1].reshape(N, m)
    u1 = U[:, 1:K].reshape(N, m) if foh else u0
    parN = par[:, None, :].expand(Bn, K - 1, par.shape[-1]).reshape(N, -1)
    dt = (t / (K - 1))[:, None].expand(Bn, K - 1).reshape(N, 1)
    return x0, u0, u1, parN, dt


def _disc_plain(model, X, U, t, par, substeps, method, foh):
    """A, B, C (FOH, else None), z of every interval, in the kernel's
    normalized time: Y' = dt (A Y + R) with
    R = [0 | B (1 - tau) | B tau | f - A x - B u] (FOH) or
    [0 | B | f - A x - B u] (ZOH)."""
    Bn, K, n = X.shape
    m = U.shape[-1]
    x0, u0, u1, parN, dt = _flat(X, U, t, par, foh)
    N = x0.shape[0]

    def G(V, tau):
        x, Y = V
        u = u0 + tau * (u1 - u0) if foh else u0
        f, A, Bm = flow_with_jacobians(model, x, u, parN)
        r = f - (A @ x[..., None])[..., 0] - (Bm @ u[..., None])[..., 0]
        cols = [torch.zeros_like(A)]
        cols += [Bm * (1.0 - tau), Bm * tau] if foh else [Bm]
        cols.append(r[..., None])
        return (dt * f, dt[..., None] * (A @ Y + torch.cat(cols, -1)))

    n_cols = n + m + (m if foh else 0) + 1
    Y0 = torch.cat([torch.eye(n, dtype=X.dtype, device=X.device).expand(
        N, n, n), X.new_zeros((N, n, n_cols - n))], -1)
    _, Y = integrate_fixed(G, (x0, Y0), 0.0, 1.0, substeps, method)
    Y = Y.reshape(Bn, K - 1, n, n_cols)
    return (Y[..., :n], Y[..., n:n + m],
            Y[..., n + m:n + 2 * m] if foh else None, Y[..., -1])


def _resim_plain(model, X, U, t, par, substeps, method, foh):
    """J = sum_k sum_i |x_end(k)_i - X[:, k+1, i]| per scenario, (B,)."""
    Bn, K, n = X.shape
    x0, u0, u1, parN, dt = _flat(X, U, t, par, foh)

    def G(x, tau):
        u = u0 + tau * (u1 - u0) if foh else u0
        return dt * model.flow_map(x, u, parN)

    x_end = integrate_fixed(G, x0, 0.0, 1.0, substeps, method)
    d = torch.abs(x_end.reshape(Bn, K - 1, n) - X[:, 1:])
    return torch.sum(torch.sum(d, dim=2), dim=1)


# ---------------------------------------------------------------------------
# the kernels and their wrappers
# ---------------------------------------------------------------------------


def _cuda_model(model):
    """The kernels' id of a model with a CUDA flow map
    (``csrc/disc_mono_body.cuh``)."""
    from scpp_tpu_torch.models.rocket_quat import RocketQuat
    if model is RocketQuat:
        return 0
    raise NotImplementedError(
        f"{getattr(model, '__name__', model)} has no CUDA flow map")


def _load_lib():
    lib = kernels.load("disc_mono")
    if lib.disc_mono_launch.argtypes is None:
        c_int, ptr = ctypes.c_int, ctypes.c_void_p
        head = [c_int] * 4 + [ptr] + [c_int] * 4 + [ptr] * 4
        lib.disc_mono_launch.argtypes = head + [ptr] * 5
        lib.resim_mono_launch.argtypes = head + [ptr]
        lib.disc_mono_launch.restype = c_int
        lib.resim_mono_launch.restype = c_int
        lib.disc_mono_smem_bytes.argtypes = [c_int] * 3
        lib.disc_mono_smem_bytes.restype = ctypes.c_longlong
        lib.disc_mono_prof_slots.argtypes = []
        lib.disc_mono_prof_slots.restype = c_int
        lib.disc_mono_threads.argtypes = []
        lib.disc_mono_threads.restype = c_int
        lib.resim_mono_threads.argtypes = []
        lib.resim_mono_threads.restype = c_int
        lib.resim_mono_smem_bytes.argtypes = [c_int] * 3
        lib.resim_mono_smem_bytes.restype = ctypes.c_longlong
    return lib


def threads() -> int:
    """Threads of one ``disc_mono`` block, read from the built kernel."""
    return int(_load_lib().disc_mono_threads())


def smem_bytes(dtype, method, foh) -> int:
    """Shared memory of one ``disc_mono`` block, bytes, read from the
    built kernel."""
    return int(_load_lib().disc_mono_smem_bytes(
        dtype.itemsize, _METHODS.index(method), int(foh)))


def resim_threads() -> int:
    """Threads of one ``resim_mono`` block, read from the built kernel."""
    return int(_load_lib().resim_mono_threads())


def resim_smem_bytes(dtype, method, foh) -> int:
    """Shared memory of one ``resim_mono`` block, bytes, read from the
    built kernel."""
    return int(_load_lib().resim_mono_smem_bytes(
        dtype.itemsize, _METHODS.index(method), int(foh)))


def _checked(model, X, U, t, par, substeps, method, foh):
    """The launch's leading arguments, after checking what the kernels
    take."""
    model_id = _cuda_model(model)
    dtype, dev = X.dtype, X.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the fused kernels take float32 or float64, not "
                        f"{dtype}")
    if method not in _METHODS:
        raise ValueError(f"method {method!r} is not one of {_METHODS}")
    Bn, K, n = X.shape
    KU = K if foh else K - 1
    shapes = {"X": (Bn, K, model.state_dim), "U": (Bn, KU, model.input_dim),
              "t": (Bn,), "par": (Bn, par.shape[-1])}
    for name, a in (("X", X), ("U", U), ("t", t), ("par", par)):
        if a.device != dev or a.dtype != dtype:
            raise ValueError(f"{name}: {a.dtype} on {a.device}, expected "
                             f"{dtype} on {dev}")
        if tuple(a.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(a.shape)}, expected "
                             f"{shapes[name]}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return [dtype.itemsize, model_id, _METHODS.index(method), int(foh)], \
        [Bn, K, KU, substeps], [a.data_ptr() for a in (X, U, t, par)]


def _disc_cuda(model, X, U, t, par, substeps, method, foh, prof=None):
    """Launch ``disc_mono_kernel`` on the current stream. ``prof``, an
    int64 (B (K-1), PROF_SLOTS) tensor on the same card, receives the
    phase counters (see ``PHASES``)."""
    head, dims, ins = _checked(model, X, U, t, par, substeps, method, foh)
    Bn, K, n = X.shape
    m = U.shape[-1]
    if prof is not None and (prof.dtype != torch.int64
                             or prof.device != X.device
                             or tuple(prof.shape) != (Bn * (K - 1),
                                                      PROF_SLOTS)
                             or not prof.is_contiguous()):
        raise ValueError(f"prof: {prof.dtype} {tuple(prof.shape)} on "
                         f"{prof.device}, expected a contiguous int64 "
                         f"{(Bn * (K - 1), PROF_SLOTS)} on {X.device}")
    A = X.new_empty((Bn, K - 1, n, n))
    Bm = X.new_empty((Bn, K - 1, n, m))
    C = X.new_empty((Bn, K - 1, n, m)) if foh else None
    z = X.new_empty((Bn, K - 1, n))
    lib = _load_lib()
    if lib.disc_mono_prof_slots() != PROF_SLOTS:
        raise RuntimeError("csrc/disc_mono.cu counts other phases than "
                           "disc_mono.PHASES")
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.disc_mono_launch(*head, stream, *dims, *ins, A.data_ptr(),
                                   Bm.data_ptr(),
                                   C.data_ptr() if foh else None,
                                   z.data_ptr(),
                                   None if prof is None else prof.data_ptr())
    if err != 0:
        raise RuntimeError(f"disc_mono kernel launch failed: CUDA error {err}")
    kernels.launches["disc_mono"] += 1
    return A, Bm, C, z


def _resim_cuda(model, X, U, t, par, substeps, method, foh):
    """Launch ``resim_mono_kernel`` on the current stream."""
    head, dims, ins = _checked(model, X, U, t, par, substeps, method, foh)
    J = X.new_empty((X.shape[0],))
    lib = _load_lib()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.resim_mono_launch(*head, stream, *dims, *ins, J.data_ptr())
    if err != 0:
        raise RuntimeError(f"resim_mono kernel launch failed: CUDA error "
                           f"{err}")
    kernels.launches["resim_mono"] += 1
    return J


def _route(cuda_fn, plain_fn, model, par, td, substeps, method):
    foh = td.interpolated_input
    if td.X.is_cuda:
        ins = [a.contiguous() for a in (td.X, td.U, td.t, par)]
        return cuda_fn(model, *ins, substeps, method, foh)
    return plain_fn(model, td.X, td.U, td.t, par, substeps, method, foh)


def multiple_shooting_fused(model, par, td: TrajectoryData,
                            substeps: int = 10,
                            method: str = "dopri5") -> DiscretizationData:
    """Fixed-final-time multiple shooting of a batch, ``par`` (B, p):
    the ``disc_mono`` kernel for tensors on the card, ``_disc_plain`` on
    the CPU."""
    A, Bm, C, z = _route(_disc_cuda, _disc_plain, model, par, td, substeps,
                         method)
    return DiscretizationData(A=A, B=Bm, z=z, C=C)


def nonlinear_defect_cost_fused(model, par, td: TrajectoryData,
                                substeps: int = 12, method: str = "dopri5"):
    """J = sum_k ||resim(x_k) - x_{k+1}||_1 per scenario, (B,): the
    ``resim_mono`` kernel for tensors on the card, ``_resim_plain`` on the
    CPU."""
    return _route(_resim_cuda, _resim_plain, model, par, td, substeps,
                  method)
