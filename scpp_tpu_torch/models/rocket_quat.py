"""6-DoF quaternion rocket landing model (counterpart of
``scpp_tpu/models/rocket_quat.py``).

State (m, r(3), v(3), q_wxyz(4), w(3)), input (thrust(3), roll torque),
dynamic params (alpha_m, g_I(3), J_B diag(3), r_T_B(3)). Params are a
dataclass of tensors; every function below takes them batched, with the
scenario axis in front (scalars (B,), vectors (B, d)), except
``default_params`` (one unbatched nominal) and ``disperse_x_init``
(which samples a batch from one nominal).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from scpp_tpu_torch.models.mathlib import (
    deg2rad, euler_xyz_to_quat, quat_to_euler_xyz, quat_to_rotmat, slerp,
)
from scpp_tpu_torch.trajectory import TrajectoryData, replace

__all__ = ["RocketQuat", "RocketQuatParams"]


def _one():
    return torch.ones(())


@dataclass
class RocketQuatParams:
    alpha_m: torch.Tensor
    g_I: torch.Tensor
    J_B: torch.Tensor
    r_T_B: torch.Tensor
    T_min: torch.Tensor
    T_max: torch.Tensor
    t_max: torch.Tensor
    gamma_gs: torch.Tensor
    gimbal_max: torch.Tensor
    theta_max: torch.Tensor
    w_B_max: torch.Tensor
    x_init: torch.Tensor
    x_final: torch.Tensor
    final_time: torch.Tensor
    m_scale: torch.Tensor = field(default_factory=_one)
    r_scale: torch.Tensor = field(default_factory=_one)
    exact_minimum_thrust: bool = True
    enable_roll_control: bool = False

    replace = replace


class RocketQuat:
    name = "RocketQuat"
    state_dim = 14
    input_dim = 4
    param_dim = 10
    Params = RocketQuatParams

    @staticmethod
    def default_params(dtype=None, device="cpu") -> RocketQuatParams:
        """Falcon-9-like stock configuration (config/RocketQuat/model.info)."""
        def f(v):
            return torch.as_tensor(v, dtype=dtype or torch.get_default_dtype(),
                                   device=device)
        I_sp = 275.0
        g = 9.81
        q_init = euler_xyz_to_quat(deg2rad(f([-20.0, 20.0, 0.0])))
        q_final = euler_xyz_to_quat(deg2rad(f([0.0, 0.0, 0.0])))
        x_init = torch.cat([f([24000.0]), f([200.0, 200.0, 800.0]),
                            f([-40.0, -40.0, -80.0]), q_init,
                            deg2rad(f([0.0, 0.0, 0.0]))])
        x_final = torch.cat([f([22000.0]), f([0.0, 0.0, 0.0]),
                             f([0.0, 0.0, 0.0]), q_final,
                             deg2rad(f([0.0, 0.0, 0.0]))])
        return RocketQuatParams(
            alpha_m=f(1.0 / (I_sp * g)),
            g_I=f([0.0, 0.0, -g]),
            J_B=f([5_000_000.0, 5_000_000.0, 70_000.0]),
            r_T_B=f([0.0, 0.0, -15.0]),
            T_min=f(200_000.0),
            T_max=f(420_000.0),
            t_max=f(17_500.0),
            gamma_gs=deg2rad(f(30.0)),
            gimbal_max=deg2rad(f(15.0)),
            theta_max=deg2rad(f(90.0)),
            w_B_max=deg2rad(f(60.0)),
            x_init=x_init,
            x_final=x_final,
            final_time=f(12.0),
            m_scale=f(1.0),
            r_scale=f(1.0),
        )

    @staticmethod
    def param_vector(p: RocketQuatParams) -> torch.Tensor:
        return torch.cat([p.alpha_m[..., None], p.g_I, p.J_B, p.r_T_B], -1)

    @staticmethod
    def flow_map(x, u, par):
        """xdot = f(x, u) (rocketQuat.cpp:7-37), on the last axis; the
        three small contractions are expanded component-wise in the same
        order as the JAX model."""
        alpha_m = par[..., 0]
        g_I = par[..., 1:4]
        J_B = par[..., 4:7]
        r_T_B = par[..., 7:10]

        m = x[..., 0]
        v = x[..., 4:7]
        q = x[..., 7:11]
        w = x[..., 11:14]

        thrust = u[..., :3]
        t0, t1, t2 = thrust[..., 0], thrust[..., 1], thrust[..., 2]
        zero = torch.zeros_like(u[..., 3])
        torque = torch.stack([zero, zero, u[..., 3]], -1)

        R = quat_to_rotmat(q)

        mdot = -alpha_m * torch.sqrt(torch.sum(thrust * thrust, dim=-1))
        rdot = v
        Rt = torch.stack([
            R[..., 0, 0] * t0 + R[..., 0, 1] * t1 + R[..., 0, 2] * t2,
            R[..., 1, 0] * t0 + R[..., 1, 1] * t1 + R[..., 1, 2] * t2,
            R[..., 2, 0] * t0 + R[..., 2, 1] * t1 + R[..., 2, 2] * t2], -1)
        vdot = Rt / m[..., None] + g_I
        w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
        q0, q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
        qdot = 0.5 * torch.stack([
            -w0 * q1 - w1 * q2 - w2 * q3,
            w0 * q0 + w2 * q2 - w1 * q3,
            w1 * q0 - w2 * q1 + w0 * q3,
            w2 * q0 + w1 * q1 - w0 * q2], -1)
        r0, r1, r2 = r_T_B[..., 0], r_T_B[..., 1], r_T_B[..., 2]
        rxT = torch.stack([r1 * t2 - r2 * t1,
                           r2 * t0 - r0 * t2,
                           r0 * t1 - r1 * t0], -1)
        wdot = (rxT + torque) / J_B
        return torch.cat([mdot[..., None], rdot, vdot, qdot, wdot], -1)

    @staticmethod
    def init_trajectory(p: RocketQuatParams, K: int,
                        interpolate_input: bool) -> TrajectoryData:
        """Linear interpolation with quaternion SLERP (rocketQuat.cpp:39-68)."""
        x_init, x_final = p.x_init, p.x_final
        Bn = x_init.shape[0]
        k = torch.arange(K, dtype=x_init.dtype, device=x_init.device)
        a1 = ((K - k) / K)[:, None]
        a2 = (k / K)[:, None]
        lin = a1 * x_init[:, None, :] + a2 * x_final[:, None, :]
        qs = slerp(x_init[:, None, 7:11], x_final[:, None, 7:11],
                   (k / K)[None, :])
        X = torch.cat([lin[..., :7], qs, lin[..., 11:14]], -1)
        n_U = K if interpolate_input else K - 1
        z = torch.zeros_like(p.T_max)
        u_hold = torch.stack([z, z, (p.T_max - p.T_min) / 2, z], -1)
        U = u_hold[:, None, :].expand(Bn, n_U, 4).contiguous()
        return TrajectoryData(X=X, U=U, t=p.final_time)

    # ---- application constraints (rocketQuat.cpp:70-144) ----

    @staticmethod
    def constraint_ref(p: RocketQuatParams, td: TrajectoryData):
        """Normalized previous thrust directions (B, n_U, 3), refreshed
        once per solve (rocketQuat.cpp:156-166)."""
        if not p.exact_minimum_thrust:
            return ()
        thrust = td.U[..., :3]
        norm = torch.linalg.vector_norm(thrust, dim=-1, keepdim=True)
        return (thrust / torch.clamp_min(norm, 1e-30),)

    _FINAL_PIN = (1, 2, 3, 4, 5, 6, 8, 9, 11, 12, 13)

    @staticmethod
    def constraints_staged(sb, x, u, p: RocketQuatParams, ref=(),
                           n_U=None):
        """The constraint set as vectorized node families, batched over
        scenarios (every tensor coefficient carries the batch axis)."""
        K = sb.K
        n_U = K if n_U is None else n_U
        un = np.arange(n_U)
        pin = list(RocketQuat._FINAL_PIN)

        sb.eq(x.sel() - p.x_init, nodes=[0])
        sb.eq(x.sel(pin) - p.x_final[:, pin], nodes=[K - 1])

        sb.nonneg(x.sel(0) - p.x_final[:, 0])

        sb.soc(x.sel(3) * torch.tan(p.gamma_gs), x.sel([1, 2]))
        sb.soc(torch.sqrt((1.0 - torch.cos(p.theta_max)) / 2.0),
               x.sel([8, 9]))
        sb.soc(p.w_B_max, x.sel([11, 12, 13]))

        sb.eq(u.sel([0, 1, 3]), nodes=[n_U - 1])

        if p.exact_minimum_thrust:
            (n_hat,) = ref
            sb.nonneg(u.lin(n_hat[:, :, None, :], idx=[0, 1, 2]) - p.T_min,
                      nodes=un)
        else:
            sb.nonneg(u.sel(2) - p.T_min, nodes=un)

        sb.soc(p.T_max, u.sel([0, 1, 2]), nodes=un)
        sb.soc(u.sel(2) * torch.tan(p.gimbal_max), u.sel([0, 1]), nodes=un)

        if p.enable_roll_control:
            sb.nonneg(-u.sel(3) + p.t_max, nodes=un)
            sb.nonneg(u.sel(3) + p.t_max, nodes=un)
        else:
            sb.eq(x.sel(13))
            sb.eq(u.sel(3), nodes=un)

    @staticmethod
    def clamp_input(p: RocketQuatParams, u):
        """Clamp inputs (B, ..., 4) into the thrust cone (LQR_sim.cpp:55-66)."""
        def pb(t):
            return t.reshape(t.shape + (1,) * (u.dim() - 1 - t.dim()))
        tz = torch.maximum(u[..., 2], pb(p.T_min))
        txy = u[..., :2]
        cone = pb(torch.tan(p.gimbal_max)) * tz
        nxy = torch.linalg.vector_norm(txy, dim=-1)
        txy = torch.where((nxy > cone)[..., None],
                          txy * (cone / torch.clamp_min(nxy, 1e-30))[..., None],
                          txy)
        T = torch.cat([txy, tz[..., None]], -1)
        nT = torch.linalg.vector_norm(T, dim=-1)
        T_max = pb(p.T_max)
        T = torch.where((nT > T_max)[..., None], T * (T_max / nT)[..., None],
                        T)
        return torch.cat([T, u[..., 3:4]], -1)

    @staticmethod
    def disperse_x_init(p: RocketQuatParams, generator, n: int, scale):
        """``n`` feasible dispersed initial states (n, 14) around the
        unbatched nominal ``p`` (rocketQuat.cpp:203-227): Gaussian on
        horizontal position and velocity, attitude rebuilt from perturbed
        Euler angles, everything kept inside the glideslope, tilt and
        rate cones so the pinned initial node stays feasible. Samples on
        the generator's device."""
        gdev = generator.device
        x_init = p.x_init.to(gdev)
        dtype = x_init.dtype
        s = float(scale)

        def normal(*shape):
            return torch.randn(shape, generator=generator, dtype=dtype,
                               device=gdev)

        def uniform(*shape):
            return 2.0 * torch.rand(shape, generator=generator, dtype=dtype,
                                    device=gdev) - 1.0

        gamma_gs, theta_max, w_B_max = (t.to(gdev) for t in
                                        (p.gamma_gs, p.theta_max, p.w_B_max))
        r_xy = x_init[1:3] + s * normal(n, 2)
        lim = 0.95 * torch.tan(gamma_gs) * x_init[3]
        nrm = torch.linalg.vector_norm(r_xy, dim=-1, keepdim=True)
        r_xy = r_xy * torch.clamp_max(lim / torch.clamp_min(nrm, 1e-30), 1.0)
        v = x_init[4:7] + 0.2 * s * normal(n, 3)
        frac = min(s / 10.0, 1.0)
        rpy0 = quat_to_euler_xyz(x_init[7:11])
        d_rp = frac * 0.3 * theta_max * uniform(n, 2)
        rp = torch.clip(rpy0[:2] + d_rp, -0.45 * theta_max, 0.45 * theta_max)
        q = euler_xyz_to_quat(torch.cat([rp, rpy0[2:3].expand(n, 1)], -1))
        w = x_init[11:14] + frac * 0.3 * w_B_max * uniform(n, 3)
        if not p.enable_roll_control:
            # roll disabled pins w_z = 0 at every node, the initial one too
            w = torch.cat([w[:, :2], torch.zeros_like(w[:, 2:])], -1)
        wn = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
        w = w * torch.clamp_max(0.9 * w_B_max / torch.clamp_min(wn, 1e-30),
                                1.0)
        return torch.cat([x_init[0:1].expand(n, 1), r_xy,
                          x_init[3:4].expand(n, 1), v, q, w], -1)

    # ---- nondimensionalization (rocketQuat.cpp:291-332) ----

    @staticmethod
    def nondimensionalize(p: RocketQuatParams) -> RocketQuatParams:
        m_scale = p.x_init[..., 0]
        r_scale = torch.linalg.vector_norm(p.x_init[..., 1:4], dim=-1)
        x_div = RocketQuat._state_scale(m_scale, r_scale)
        mr = m_scale * r_scale
        mr2 = m_scale * r_scale ** 2
        return p.replace(
            alpha_m=p.alpha_m * r_scale,
            r_T_B=p.r_T_B / r_scale[..., None],
            g_I=p.g_I / r_scale[..., None],
            J_B=p.J_B / mr2[..., None],
            x_init=p.x_init / x_div,
            x_final=p.x_final / x_div,
            T_min=p.T_min / mr,
            T_max=p.T_max / mr,
            t_max=p.t_max / mr2,
            m_scale=m_scale,
            r_scale=r_scale,
        )

    @staticmethod
    def _state_scale(m_scale, r_scale):
        """Per-state scale vector (..., 14): mass by m_scale, r and v by
        r_scale, the rest 1."""
        shape = m_scale.shape
        return torch.cat([m_scale[..., None],
                          r_scale[..., None].expand(shape + (6,)),
                          torch.ones(shape + (7,), dtype=m_scale.dtype,
                                     device=m_scale.device)], -1)

    @staticmethod
    def _input_scale(p):
        mr = p.m_scale * p.r_scale
        return torch.cat([mr[..., None].expand(mr.shape + (3,)),
                          (p.m_scale * p.r_scale ** 2)[..., None]], -1)

    @staticmethod
    def scale_trajectory(p: RocketQuatParams,
                         td: TrajectoryData) -> TrajectoryData:
        x_div = RocketQuat._state_scale(p.m_scale, p.r_scale)
        u_div = RocketQuat._input_scale(p)
        return td.replace(X=td.X / x_div[..., None, :],
                          U=td.U / u_div[..., None, :])

    @staticmethod
    def unscale_trajectory(p: RocketQuatParams,
                           td: TrajectoryData) -> TrajectoryData:
        x_mul = RocketQuat._state_scale(p.m_scale, p.r_scale)
        u_mul = RocketQuat._input_scale(p)
        return td.replace(X=td.X * x_mul[..., None, :],
                          U=td.U * u_mul[..., None, :])
