"""Minimal SO(3)/SE(3) utilities (counterpart of
``tauv_vision_tpu/ops/se3.py``), the same formulas in the same op order.
"""

from __future__ import annotations

from typing import Tuple

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: [..., 3] -> [..., 3, 3] skew matrices."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle [..., 3] -> rotation matrix [..., 3, 3].

    Gradient-safe at w = 0 (the PnP solver linearises there): the angle is
    an epsilon-regularised norm, so d(theta)/dw -> 0 instead of NaN, and
    the sin/cos coefficients switch to their Taylor series for small
    angles; ``safe_theta`` keeps the unused branch of each ``where``
    finite, so its gradient is too."""
    theta_sq_raw = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta_sq_raw + 1e-24)  # [..., 1, 1]
    k = hat(w)
    k2 = k @ k
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(k.shape)

    theta_sq = theta**2
    small = theta < 1e-4
    safe_theta = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(safe_theta) / safe_theta)
    b = torch.where(
        small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(safe_theta)) / safe_theta**2
    )
    return eye + a * k + b * k2


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3]."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_theta)

    v = torch.stack(
        [
            r[..., 2, 1] - r[..., 1, 2],
            r[..., 0, 2] - r[..., 2, 0],
            r[..., 1, 0] - r[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta = torch.sin(theta)
    small = torch.abs(sin_theta) < 1e-6
    scale = torch.where(
        small, 0.5 + theta**2 / 12.0,
        theta / (2.0 * torch.where(small, torch.ones_like(sin_theta), sin_theta)),
    )
    return scale[..., None] * v


def rpy_to_matrix(roll: torch.Tensor, pitch: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """ZYX (yaw-pitch-roll) Euler angles to a rotation matrix."""
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    return torch.stack(
        [
            torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
            torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
            torch.stack([-sp, cp * sr, cp * cr], -1),
        ],
        dim=-2,
    )


def matrix_to_rpy(r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rotation matrix -> (roll, pitch, yaw), ZYX convention."""
    pitch = torch.arcsin(torch.clamp(-r[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(r[..., 2, 1], r[..., 2, 2])
    yaw = torch.atan2(r[..., 1, 0], r[..., 0, 0])
    return roll, pitch, yaw


def se3_transform(rotation: torch.Tensor, translation: torch.Tensor,
                  points: torch.Tensor) -> torch.Tensor:
    """Apply (R, t) to [..., N, 3] points."""
    return points @ rotation.transpose(-1, -2) + translation[..., None, :]
