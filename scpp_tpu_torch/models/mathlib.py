"""Rotation / quaternion helpers (counterpart of
``scpp_tpu/models/mathlib.py``), on the last axis so that they batch
over any leading dimensions and trace under ``torch.func``.

Quaternions are (w, x, y, z).
"""

from __future__ import annotations

import math

import torch

__all__ = ["deg2rad", "rot2d", "quat_mul", "quat_to_rotmat",
           "euler_xyz_to_quat", "quat_to_euler_xyz", "slerp"]


def deg2rad(x):
    return x * (math.pi / 180.0)


def rot2d(angle):
    """2x2 rotation matrices of angles (...,) -> (..., 2, 2)."""
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([torch.stack([c, -s], -1),
                        torch.stack([s, c], -1)], -2)


def quat_mul(q1, q2):
    """Hamilton product of (w,x,y,z) quaternions."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_to_rotmat(q):
    """Rotation matrix of a raw (unnormalized) quaternion, (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def _axis_angle_quat(axis_idx: int, angle):
    half = 0.5 * angle
    zero = torch.zeros_like(angle)
    q = [torch.cos(half), zero, zero, zero]
    q[1 + axis_idx] = torch.sin(half)
    return torch.stack(q, dim=-1)


def euler_xyz_to_quat(eta):
    """Intrinsic x-y'-z'' Euler angles (..., 3) -> quaternion (..., 4)."""
    qx = _axis_angle_quat(0, eta[..., 0])
    qy = _axis_angle_quat(1, eta[..., 1])
    qz = _axis_angle_quat(2, eta[..., 2])
    return quat_mul(quat_mul(qx, qy), qz)


def quat_to_euler_xyz(q):
    """Inverse of euler_xyz_to_quat."""
    R = quat_to_rotmat(q)
    phi = torch.atan2(-R[..., 1, 2], R[..., 2, 2])
    theta = torch.asin(R[..., 0, 2])
    psi = torch.atan2(-R[..., 0, 1], R[..., 0, 0])
    return torch.stack([phi, theta, psi], dim=-1)


def slerp(q0, q1, alpha):
    """Spherical linear interpolation, Eigen-compatible shortest path.
    ``q0``/``q1`` (..., 4) and ``alpha`` (...) broadcast together."""
    d = (q0 * q1).sum(-1)
    abs_d = torch.abs(d)
    theta = torch.arccos(torch.clip(abs_d, 0.0, 1.0))
    sin_theta = torch.sin(theta)
    near = abs_d > 1.0 - 1e-9
    safe_sin = torch.where(near, torch.ones_like(sin_theta), sin_theta)
    scale0 = torch.where(near, 1.0 - alpha,
                         torch.sin((1.0 - alpha) * theta) / safe_sin)
    scale1 = torch.where(near, alpha, torch.sin(alpha * theta) / safe_sin)
    scale1 = torch.where(d < 0, -scale1, scale1)
    return scale0[..., None] * q0 + scale1[..., None] * q1
