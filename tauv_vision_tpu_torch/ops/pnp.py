"""Perspective-n-Point pose recovery (counterpart of
``tauv_vision_tpu/ops/pnp.py``): Levenberg-Marquardt on SE(3) in plain
tensor ops, so pose recovery stays on the device inside the request.

Masked points weigh 0, so the ragged ">= 6 keypoints" gate of the
reference becomes a fixed-shape computation: PnP runs for every
detection slot and ``n_points >= min_points`` (``MIN_POINTS`` unless the
caller passes another, as YOLO-Pose's 4) validates the result.

The solver works on a batch of problems directly (``solve_pnp`` is a
batch of one), and the residual's Jacobian is written out by hand
(``_jacobian``): the derivative of ``so3_exp``'s formula, branch for
branch, times the pinhole projection's.  The JAX package takes it with
``jax.jacobian`` (reverse mode) through the same ops, so the two agree
to f32 rounding (not bit for bit: each sums the chain rule's terms in
its own order); the 20 steps then agree to about 1e-6 on a well-posed
problem and may part on an ill-posed one (random correspondences), where
LM is chaotic.  ``torch.func.jacrev`` under ``vmap`` would follow JAX's
ops more closely, but the pipelines run inside ``torch.inference_mode``,
and there torch 2.11 (on an H100 and on the CPU alike) returns a
Jacobian of zeros, where under autograd or ``no_grad`` it equals this
one to f32 rounding; torch 2.13 is right in every mode
(``scripts/jacrev_probe.py``).  Its dispatch also cost thousands of
small launches a request.

The steps are a Python loop whose accept/reject is a ``torch.where``:
nothing syncs with the host, so a request stays asynchronous on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tauv_vision_tpu_torch.ops.se3 import hat, so3_exp

# The reference's gate (a pose needs at least 6 correspondences) and the
# served solver's LM step count.
MIN_POINTS = 6
PNP_ITERATIONS = 20


class PnPResult(NamedTuple):
    rotation: torch.Tensor     # [..., 3, 3]
    translation: torch.Tensor  # [..., 3]
    error: torch.Tensor        # [...] mean squared reprojection error (px^2)
    valid: torch.Tensor        # [...] bool (enough points and a finite result)


def _project(points_cam: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    z = torch.clamp_min(points_cam[..., 2], 1e-6)
    u = fx * points_cam[..., 0] / z + cx
    v = fy * points_cam[..., 1] / z + cy
    return torch.stack((u, v), dim=-1)


def _solve_spd_6(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the 6x6 SPD system a @ x = b by an unrolled Cholesky, the
    function the JAX package computes (it avoids a linear-algebra custom
    call there)."""
    n = 6
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                l[i][j] = torch.sqrt(torch.clamp_min(s, 1e-12))
            else:
                l[i][j] = s / l[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return torch.stack(x, dim=-1)


def _camera_points(params: torch.Tensor, object_points: torch.Tensor) -> torch.Tensor:
    """so3_exp(w) X + t of params = (w, t) [N, 6], X [N, P, 3]."""
    return object_points @ so3_exp(params[:, :3]).mT + params[:, None, 3:]


def _jacobian(params: torch.Tensor, object_points: torch.Tensor, pts: torch.Tensor,
              mask: torch.Tensor, fx, fy) -> torch.Tensor:
    """d residual / d params, [N, 2P, 6], of the residual
    ``((project(so3_exp(w) X + t) - uv) * mask)`` flattened as (u, v) a
    point, params = (w, t) [N, 6], at the camera points ``pts``.

    R(w) X = X + a (w x X) + b (w x (w x X)) with a, b of theta =
    sqrt(|w|^2 + 1e-24), in ``so3_exp``'s two branches, so
    d(R X)/dw = (w x X) da/dw - a [X]x + (w x (w x X)) db/dw
    + b ((w.X) I + w X^T - 2 X w^T)."""
    w = params[:, :3]
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(theta_sq + 1e-24)                       # [N, 1]
    small = theta < 1e-4
    safe = torch.where(small, torch.ones_like(theta), theta)
    sin, cos = torch.sin(safe), torch.cos(safe)
    a = torch.where(small, 1.0 - theta**2 / 6.0, sin / safe)
    b = torch.where(small, 0.5 - theta**2 / 24.0, (1.0 - cos) / safe**2)
    da_dw = torch.where(small, -w / 3.0, (safe * cos - sin) / safe**3 * w)
    db_dw = torch.where(small, -w / 12.0, (safe * sin - 2.0 * (1.0 - cos)) / safe**4 * w)

    x = object_points                                          # [N, P, 3]
    wp = w[:, None].expand_as(x)
    c1 = torch.linalg.cross(wp, x)
    c2 = torch.linalg.cross(wp, c1)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    w_dot_x = torch.sum(wp * x, dim=-1)[..., None, None]
    d_rx = (c1[..., :, None] * da_dw[:, None, None, :]
            - a[:, None, None] * hat(x)
            + c2[..., :, None] * db_dw[:, None, None, :]
            + b[:, None, None] * (w_dot_x * eye + wp[..., :, None] * x[..., None, :]
                                  - 2.0 * x[..., :, None] * wp[..., None, :]))  # [N, P, 3, 3]

    z = torch.clamp_min(pts[..., 2], 1e-6)
    dz = (pts[..., 2] > 1e-6).to(x.dtype)                      # the clamp's derivative
    zeros = torch.zeros_like(z)
    du = torch.stack((fx / z, zeros, -fx * pts[..., 0] / z**2 * dz), dim=-1)   # [N, P, 3]
    dv = torch.stack((zeros, fy / z, -fy * pts[..., 1] / z**2 * dz), dim=-1)
    d_pts = torch.cat((d_rx, eye.expand_as(d_rx)), dim=-1)    # [N, P, 3, 6]
    jac = torch.stack(((du[..., None] * d_pts).sum(-2), (dv[..., None] * d_pts).sum(-2)),
                      dim=-2)                                  # [N, P, 2, 6]
    return (jac * mask[..., None, None]).reshape(x.shape[0], -1, 6)


def solve_pnp_batch(
    object_points: torch.Tensor,
    image_points: torch.Tensor,
    camera_matrix: torch.Tensor,
    mask: torch.Tensor,
    n_iterations: int = PNP_ITERATIONS,
    min_points: int = MIN_POINTS,
) -> PnPResult:
    """LM-refined PnP for a batch of point sets.

    Args:
      object_points: [N, P, 3] 3D points in the object frame.
      image_points: [N, P, 2] (u, v) pixel observations.
      camera_matrix: [3, 3] (or [3, 4]) intrinsics.
      mask: [N, P] bool validity of each correspondence.
      min_points: the correspondences a valid pose needs.
    """
    fx, fy = camera_matrix[0, 0], camera_matrix[1, 1]
    cx, cy = camera_matrix[0, 2], camera_matrix[1, 2]
    w = mask.to(torch.float32)
    n_points = w.sum(-1)                                       # [N]
    n_safe = torch.clamp_min(n_points, 1.0)[:, None]
    wp = w[..., None]

    # Initialisation: the object centred in front of the camera at a depth
    # scaled from the image-point spread (a weak-perspective guess).
    obj_center = (object_points * wp).sum(1) / n_safe          # [N, 3]
    img_center = (image_points * wp).sum(1) / n_safe           # [N, 2]
    obj_spread = torch.sqrt(((object_points - obj_center[:, None]) ** 2).sum(-1) * w
                            ).sum(-1, keepdim=True) / n_safe
    img_spread = torch.sqrt(((image_points - img_center[:, None]) ** 2).sum(-1) * w
                            ).sum(-1, keepdim=True) / n_safe
    z0 = fx * obj_spread / torch.clamp_min(img_spread, 1e-3)
    z0 = torch.clamp(z0, 0.05, 100.0)                          # [N, 1]
    t0 = torch.cat(
        [
            (img_center[:, 0:1] - cx) / fx * z0,
            (img_center[:, 1:2] - cy) / fy * z0,
            z0,
        ],
        dim=-1,
    ) - obj_center

    def residual(pts):
        proj = _project(pts, fx, fy, cx, cy)
        return ((proj - image_points) * wp).reshape(pts.shape[0], -1)

    eye6 = torch.eye(6, dtype=torch.float32, device=object_points.device)
    params = torch.cat([torch.zeros_like(t0), t0], dim=-1)     # [N, 6]
    damping = torch.full((params.shape[0], 1), 1e-3, dtype=torch.float32,
                         device=object_points.device)
    for _ in range(n_iterations):
        pts = _camera_points(params, object_points)
        res = residual(pts)                                    # [N, 2P]
        jac = _jacobian(params, object_points, pts, w, fx, fy)  # [N, 2P, 6]
        jtj = jac.mT @ jac
        jtr = (jac.mT @ res[..., None])[..., 0]
        lhs = jtj + damping[..., None] * eye6 * (1.0 + torch.diagonal(jtj, dim1=-2, dim2=-1))[:, None]
        new_params = params + _solve_spd_6(lhs, -jtr)
        new_cost = (residual(_camera_points(new_params, object_points)) ** 2
                    ).sum(-1, keepdim=True)
        old_cost = (res**2).sum(-1, keepdim=True)
        improved = new_cost < old_cost
        params = torch.where(improved, new_params, params)
        damping = torch.where(improved, damping * 0.5, damping * 4.0)
        damping = torch.clamp(damping, 1e-8, 1e6)

    rotation = so3_exp(params[:, :3])
    translation = params[:, 3:]
    error = (residual(_camera_points(params, object_points)) ** 2).sum(-1) / n_safe[:, 0]
    valid = (n_points >= min_points) & torch.isfinite(error)
    return PnPResult(rotation=rotation, translation=translation, error=error, valid=valid)


def solve_pnp(
    object_points: torch.Tensor,
    image_points: torch.Tensor,
    camera_matrix: torch.Tensor,
    mask: torch.Tensor,
    n_iterations: int = PNP_ITERATIONS,
) -> PnPResult:
    """LM-refined PnP for one point set: object_points [P, 3], image_points
    [P, 2], mask [P]; ``solve_pnp_batch`` of a batch of one."""
    out = solve_pnp_batch(object_points[None], image_points[None], camera_matrix, mask[None],
                          n_iterations)
    return PnPResult(*(f[0] for f in out))
