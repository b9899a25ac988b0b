"""Planar rocket landing model (counterpart of
``scpp_tpu/models/rocket2d.py``).

State (r(2), v(2), eta, omega), input (gimbal angle, thrust magnitude),
dynamic params (m, J_B, g_I(2), r_T_B(2)). Every function below takes
the params batched, with the scenario axis in front (scalars (B,),
vectors (B, d)), except ``default_params`` (one unbatched nominal).

This slice ports what the receding-horizon MPC runs: the flow map, the
hover operating point, the initial guess, the dense constraints and the
input clamp. ``from_info``, ``constraints_staged``, ``disperse_x_init``
and the (non)dimensionalization wait for the SC slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from scpp_tpu_torch.models.mathlib import deg2rad, rot2d
from scpp_tpu_torch.trajectory import TrajectoryData, replace

__all__ = ["Rocket2D", "Rocket2DParams"]


def _one():
    return torch.ones(())


@dataclass
class Rocket2DParams:
    # physical
    m: torch.Tensor
    J_B: torch.Tensor
    g_I: torch.Tensor      # (2,)
    r_T_B: torch.Tensor    # (2,)
    T_min: torch.Tensor
    T_max: torch.Tensor
    # constraint bounds (radians)
    gamma_gs: torch.Tensor
    gimbal_max: torch.Tensor
    theta_max: torch.Tensor
    w_B_max: torch.Tensor
    # boundary conditions
    x_init: torch.Tensor   # (6,)
    x_final: torch.Tensor  # (6,)
    final_time: torch.Tensor
    # nondimensionalization scales (identity when dimensional)
    m_scale: torch.Tensor = field(default_factory=_one)
    r_scale: torch.Tensor = field(default_factory=_one)
    # structure flag (changes the constraint set)
    constrain_initial_final: bool = True

    replace = replace


class Rocket2D:
    """Namespace of functions defining the planar rocket."""

    name = "Rocket2D"
    state_dim = 6   # x, y, vx, vy, eta, omega
    input_dim = 2   # gimbal angle, thrust magnitude
    param_dim = 6   # m, J_B, g_I(2), r_T_B(2)
    Params = Rocket2DParams

    @staticmethod
    def default_params(dtype=None, device="cpu") -> Rocket2DParams:
        """Stock Rocket2D configuration (config/Rocket2D/model.info)."""
        def f(v):
            return torch.as_tensor(v, dtype=dtype or torch.get_default_dtype(),
                                   device=device)
        return Rocket2DParams(
            m=f(24000.0),
            J_B=f(5_000_000.0),
            g_I=f([0.0, -9.81]),
            r_T_B=f([0.0, -15.0]),
            T_min=f(10_000.0),
            T_max=f(420_000.0),
            gamma_gs=deg2rad(f(45.0)),
            gimbal_max=deg2rad(f(15.0)),
            theta_max=deg2rad(f(60.0)),
            w_B_max=deg2rad(f(20.0)),
            x_init=torch.cat([f([-200.0, 800.0]), f([0.0, -100.0]),
                              deg2rad(f([-20.0])), deg2rad(f([0.0]))]),
            x_final=torch.cat([f([0.0, 0.0]), f([0.0, -1.0]), f([0.0]),
                               f([0.0])]),
            final_time=f(12.0),
            m_scale=f(1.0),
            r_scale=f(1.0),
        )

    @staticmethod
    def param_vector(p: Rocket2DParams) -> torch.Tensor:
        """Dynamic parameter vector fed to flow_map (rocket2d.cpp:143-148)."""
        return torch.cat([p.m[..., None], p.J_B[..., None], p.g_I, p.r_T_B],
                         -1)

    @staticmethod
    def flow_map(x, u, par):
        """xdot = f(x, u) (rocket2d.cpp:7-38), on the last axis."""
        m, J_B = par[..., 0], par[..., 1]
        g_I = par[..., 2:4]
        r_T_B = par[..., 4:6]

        v = x[..., 2:4]
        eta = x[..., 4]
        w = x[..., 5]

        angle, magnitude = u[..., 0], u[..., 1]
        # thrust vector in body frame: Rot(angle) @ [0, magnitude]
        thrust = torch.stack([torch.zeros_like(magnitude), magnitude], -1)
        T_B = (rot2d(angle) @ thrust[..., None])[..., 0]
        R_I_B = rot2d(eta)

        acc = (R_I_B @ T_B[..., None])[..., 0] / m[..., None] + g_I
        wdot = (r_T_B[..., 0] * T_B[..., 1] - r_T_B[..., 1] * T_B[..., 0]) \
            / J_B
        return torch.cat([v, acc, w[..., None], wdot[..., None]], -1)

    @staticmethod
    def operating_point(p: Rocket2DParams):
        """Hover equilibrium for MPC/LQR (rocket2d.cpp:40-44): (B, 6) and
        (B, 2)."""
        x_eq = torch.zeros(p.x_init.shape, dtype=p.x_init.dtype,
                           device=p.x_init.device)
        u_eq = torch.stack([torch.zeros_like(p.m), -p.g_I[..., 1] * p.m], -1)
        return x_eq, u_eq

    @staticmethod
    def init_trajectory(p: Rocket2DParams, K: int,
                        interpolate_input: bool) -> TrajectoryData:
        """Straight-line interpolation, mid-thrust (rocket2d.cpp:120-136)."""
        x_init, x_final = p.x_init, p.x_final
        Bn = x_init.shape[0]
        k = torch.arange(K, dtype=x_init.dtype, device=x_init.device)
        a1 = ((K - k) / K)[:, None]
        a2 = (k / K)[:, None]
        X = a1 * x_init[:, None, :] + a2 * x_final[:, None, :]
        n_U = K if interpolate_input else K - 1
        u_hold = torch.stack([torch.zeros_like(p.T_max),
                              (p.T_max + p.T_min) / 2], -1)
        U = u_hold[:, None, :].expand(Bn, n_U, 2).contiguous()
        return TrajectoryData(X=X, U=U, t=p.final_time)

    # ---- application constraints (rocket2d.cpp:46-84) ----

    @staticmethod
    def constraint_ref(p: Rocket2DParams, td: TrajectoryData):
        """No linearized constraints -> empty ref."""
        return ()

    @staticmethod
    def constraints(pb, v_X, v_U, p: Rocket2DParams, ref=()):
        """Add the model's convex constraints to a conic problem builder
        (``solver/builder.py``); the bounds come batched, so their rows
        differ per scenario. ``v_X`` has shape (K, 6), ``v_U`` (n_U, 2)."""
        K = v_X.shape[0]
        n_U = v_U.shape[0]

        if p.constrain_initial_final:
            pb.add_eq(v_X[0] - p.x_init)
            pb.add_eq(v_X[K - 1] - p.x_final)
            pb.add_eq(v_U[n_U - 1, 0])  # zero final gimbal

        tan_gs = torch.tan(p.gamma_gs)
        for k in range(K):
            # glideslope |x| <= tan(gamma_gs) * y as a dim-2 SOC
            pb.add_soc(v_X[k, 1] * tan_gs, v_X[k, 0])
        # tilt box
        pb.add_nonneg(p.theta_max - v_X[:, 4])
        pb.add_nonneg(v_X[:, 4] + p.theta_max)
        # angular velocity box
        pb.add_nonneg(p.w_B_max - v_X[:, 5])
        pb.add_nonneg(v_X[:, 5] + p.w_B_max)
        # gimbal box
        pb.add_nonneg(p.gimbal_max - v_U[:, 0])
        pb.add_nonneg(v_U[:, 0] + p.gimbal_max)
        # thrust box
        pb.add_nonneg(v_U[:, 1] - p.T_min)
        pb.add_nonneg(p.T_max - v_U[:, 1])

    @staticmethod
    def clamp_input(p: Rocket2DParams, u):
        """Project controller outputs (B, 2) into the physical input set
        (the LQR_sim.cpp:55-66 pattern for the planar model)."""
        return torch.stack([
            torch.clamp(u[..., 0], -p.gimbal_max, p.gimbal_max),
            torch.clamp(u[..., 1], p.T_min, p.T_max),
        ], -1)
