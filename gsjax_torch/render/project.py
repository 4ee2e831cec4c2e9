"""Per-splat 3D→2D projection — the PyTorch counterpart of
gsjax/render/project.py: Σ → screen-space conic via the perspective
Jacobian, frustum cull, footprint radius and SH color, all in float32.
Elementwise over N splats; not a kernel in either package."""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch.core.camera import Camera
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.core.gaussians import Gaussians
from gsjax_torch.render.sh import eval_sh


@dataclasses.dataclass(frozen=True)
class ProjectedSplats:
    """Screen-space splats.

    mean2d  [N, 2] pixel coords (pixel centers at integer coordinates)
    depth   [N]    camera-space z
    conic   [N, 3] (a, b, c): weight = exp(-0.5(a dx² + 2b dx dy + c dy²))
    radius  [N]    footprint radius in pixels (0 ⇒ culled)
    rgb     [N, 3] SH-evaluated color
    opacity [N]    activated opacity in [0, 1]
    valid   [N]    bool cull mask
    """

    mean2d: torch.Tensor
    depth: torch.Tensor
    conic: torch.Tensor
    radius: torch.Tensor
    rgb: torch.Tensor
    opacity: torch.Tensor
    valid: torch.Tensor


def project(g: Gaussians, cam: Camera, cfg: RenderConfig = RenderConfig()
            ) -> ProjectedSplats:
    view = cam.view_matrix()
    W = view[:3, :3]
    t_cam = torch.sum(g.means[:, None, :] * W[None, :, :], dim=-1) + view[:3, 3]
    z = t_cam[:, 2]
    in_front = z > cfg.near_cull

    tan_fovx, tan_fovy = cam.tan_half_fov()
    limx, limy = 1.3 * tan_fovx, 1.3 * tan_fovy
    zc = torch.where(in_front, z, torch.ones_like(z))
    tx = torch.clamp(t_cam[:, 0] / zc, -limx, limx) * zc
    ty = torch.clamp(t_cam[:, 1] / zc, -limy, limy) * zc

    fx, fy = cam.fx, cam.fy
    inv_z = 1.0 / zc
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2

    # T = J @ W (2×3); cov2d = T Σ Tᵀ with Σ = M Mᵀ, M = R·diag(s)
    T0 = j00[:, None] * W[0][None, :] + j02[:, None] * W[2][None, :]
    T1 = j11[:, None] * W[1][None, :] + j12[:, None] * W[2][None, :]
    R = g.rotation_matrices()
    M = R * g.scales[:, None, :]
    a0 = torch.sum(T0[:, :, None] * M, dim=1)
    a1 = torch.sum(T1[:, :, None] * M, dim=1)
    c00 = torch.sum(a0 * a0, dim=-1) + cfg.lowpass
    c01 = torch.sum(a0 * a1, dim=-1)
    c11 = torch.sum(a1 * a1, dim=-1) + cfg.lowpass

    det = c00 * c11 - c01 * c01
    det_ok = det > 0.0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe
    conic = torch.stack([c11 * inv_det, -c01 * inv_det, c00 * inv_det], dim=-1)

    mid = 0.5 * (c00 + c11)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det_safe, min=0.1))
    radius = torch.ceil(cfg.radius_sigma * torch.sqrt(lam1))

    cx = (cam.width - 1.0) * 0.5
    cy = (cam.height - 1.0) * 0.5
    mean2d = torch.stack(
        [fx * t_cam[:, 0] * inv_z + cx, fy * t_cam[:, 1] * inv_z + cy], dim=-1
    )
    on_screen = (
        (mean2d[:, 0] + radius >= 0)
        & (mean2d[:, 0] - radius < cam.width)
        & (mean2d[:, 1] + radius >= 0)
        & (mean2d[:, 1] - radius < cam.height)
    )

    opacity = g.opacities
    dirs = g.means - cam.position
    # smoothed norm: a splat at the camera position must not give 0/0
    dirs = dirs / torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True) + 1e-24)
    rgb = eval_sh(g.sh, dirs)

    valid = in_front & det_ok & on_screen & (opacity >= cfg.alpha_min)
    return ProjectedSplats(
        mean2d=mean2d,
        depth=z,
        conic=conic,
        radius=torch.where(valid, radius, torch.zeros_like(radius)),
        rgb=rgb,
        opacity=opacity,
        valid=valid,
    )
