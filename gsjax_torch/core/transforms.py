"""Scene edits on Gaussians — the PyTorch counterpart of
gsjax/core/transforms.py:

  translate  — shift every position
  rotate     — rotate positions about the origin and compose each
               splat's orientation
  scale      — a scalar scales positions and splat sizes; per-axis
               factors scale positions only (a per-axis scale would shear
               rotated covariances)
  limit_box  — soft delete outside an axis-aligned box (opacity logit
               −30, N unchanged)
  crop_box   — hard crop (a smaller scene)

Each returns a new Gaussians on g's device. Its edited fields are
computed from g's under autograd, so a loss on the result reaches g's
parameters (as jax.grad does through gsjax's edits); made under
torch.no_grad() (scene editing), the result holds fresh parameters
(core/gaussians.Gaussians). crop_box always makes fresh ones, as gsjax's
host-side crop does.
"""

from __future__ import annotations

import torch

from gsjax_torch.core.gaussians import FIELDS, Gaussians, quat_to_rotmat


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (w, x, y, z) quaternions, broadcast."""
    w1, x1, y1, z1 = torch.unbind(q1, dim=-1)
    w2, x2, y2, z2 = torch.unbind(q2, dim=-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def _f32(v, g: Gaussians) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32).to(g.device)


def _replace(g: Gaussians, **fields) -> Gaussians:
    return Gaussians(*(fields.get(f, getattr(g, f)) for f in FIELDS))


def translate(g: Gaussians, offset) -> Gaussians:
    return _replace(g, means=g.means + _f32(offset, g))


def rotate(g: Gaussians, quat) -> Gaussians:
    """Rotate the whole scene by quaternion (w, x, y, z) about the origin."""
    quat = _f32(quat, g)
    quat = quat / torch.clamp(torch.linalg.vector_norm(quat), min=1e-12)
    R = quat_to_rotmat(quat)
    return _replace(g, means=g.means @ R.T,
                    quats=quat_multiply(quat[None, :], g.normalized_quats()))


def scale(g: Gaussians, factor) -> Gaussians:
    """A scalar factor scales positions and splat sizes; per-axis factors
    scale positions only."""
    factor = _f32(factor, g)
    if factor.ndim == 0:
        return _replace(g, means=g.means * factor,
                        log_scales=g.log_scales + torch.log(factor))
    return _replace(g, means=g.means * factor)


def _inside(m, xmin, xmax, ymin, ymax, zmin, zmax) -> torch.Tensor:
    return ((m[:, 0] >= xmin) & (m[:, 0] <= xmax) & (m[:, 1] >= ymin)
            & (m[:, 1] <= ymax) & (m[:, 2] >= zmin) & (m[:, 2] <= zmax))


def limit_box(g: Gaussians, xmin, xmax, ymin, ymax, zmin, zmax) -> Gaussians:
    """Soft-delete the splats outside the box: opacity logit −30."""
    if not (xmin < xmax and ymin < ymax and zmin < zmax):
        raise ValueError("limit_box: min must be < max on every axis")
    inside = _inside(g.means.detach(), xmin, xmax, ymin, ymax, zmin, zmax)
    return _replace(g, opacity_logits=torch.where(inside, g.opacity_logits, -30.0))


def crop_box(g: Gaussians, xmin, xmax, ymin, ymax, zmin, zmax) -> Gaussians:
    """Hard crop: the splats inside the box, as fresh parameters."""
    with torch.no_grad():
        idx = torch.nonzero(_inside(g.means, xmin, xmax, ymin, ymax, zmin, zmax)).squeeze(1)
        return Gaussians(*(getattr(g, f).index_select(0, idx) for f in FIELDS))
