"""The splat store as an `nn.Module` of raw training parameters — the
PyTorch counterpart of gsjax/core/gaussians.py.

  means          [N, 3]    world-space centers
  log_scales     [N, 3]    log of per-axis std-dev
  quats          [N, 4]    rotation (w, x, y, z), normalized on use
  sh             [N, K, 3] spherical-harmonic coefficients, K ∈ {1,4,9,16}
  opacity_logits [N]       logit of opacity

Σ = R S Sᵀ Rᵀ with S = diag(exp(log_scales)).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

SH_C0 = 0.28209479177387814


class Gaussians(nn.Module):
    def __init__(self, means, log_scales, quats, sh, opacity_logits):
        super().__init__()
        self.means = nn.Parameter(means)
        self.log_scales = nn.Parameter(log_scales)
        self.quats = nn.Parameter(quats)
        self.sh = nn.Parameter(sh)
        self.opacity_logits = nn.Parameter(opacity_logits)

    @property
    def device(self) -> torch.device:
        return self.means.device

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_numpy(means, log_scales, quats, sh, opacity_logits,
                   device="cuda") -> "Gaussians":
        """Raw parameters as numpy arrays (e.g. a gsjax scene's fields) →
        Gaussians on `device`, bit for bit. The card by default: a CPU
        caller passes device="cpu" (there is no silent fallback)."""
        t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        return Gaussians(t(means), t(log_scales), t(quats), t(sh),
                         t(opacity_logits))

    @staticmethod
    def from_activated(means, scales, quats, opacities, rgb=None, sh=None,
                       device="cuda") -> "Gaussians":
        """Build from activated values: linear scales, [0,1] opacities, and
        either direct RGB in [0,1] (degree 0) or SH coefficients. On the
        card unless device="cpu" is passed."""
        t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        means, scales, quats = t(means), t(scales), t(quats)
        opacities = torch.clamp(t(opacities), 1e-6, 1.0 - 1e-6)
        if sh is None:
            if rgb is None:
                raise ValueError("provide rgb or sh")
            sh = ((t(rgb) - 0.5) / SH_C0)[:, None, :]
        else:
            sh = t(sh)
        return Gaussians(
            means,
            torch.log(torch.clamp(scales, min=1e-12)),
            quats,
            sh,
            torch.log(opacities) - torch.log1p(-opacities),
        )

    # -- activated views ----------------------------------------------------

    @property
    def scales(self) -> torch.Tensor:
        return torch.exp(self.log_scales)

    @property
    def opacities(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity_logits)

    def normalized_quats(self) -> torch.Tensor:
        q = self.quats
        # smoothed norm: the max-clamped norm's gradient at q = 0 is NaN
        return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-24)

    def rotation_matrices(self) -> torch.Tensor:
        """[N, 3, 3] rotation matrices from normalized (w,x,y,z) quats."""
        return quat_to_rotmat(self.normalized_quats())


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] from normalized (w, x, y, z) quats."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z),
            2 * (x * y - w * z),
            2 * (x * z + w * y),
            2 * (x * y + w * z),
            1 - 2 * (x * x + z * z),
            2 * (y * z - w * x),
            2 * (x * z - w * y),
            2 * (y * z + w * x),
            1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(*q.shape[:-1], 3, 3)


def rotmat_to_quat(R) -> np.ndarray:
    """Inverse of quat_to_rotmat for host-side camera IO. Numpy, batched
    [..., 3, 3] -> [..., 4] (w, x, y, z) float32."""
    R = np.asarray(R, np.float64)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    c0 = tr > 0
    s = np.sqrt(np.maximum(tr + 1.0, 0)) * 2
    with np.errstate(divide="ignore", invalid="ignore"):
        q0 = np.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s], -1)
        s1 = np.sqrt(np.maximum(1.0 + m00 - m11 - m22, 0)) * 2
        q1 = np.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
        s2 = np.sqrt(np.maximum(1.0 + m11 - m00 - m22, 0)) * 2
        q2 = np.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
        s3 = np.sqrt(np.maximum(1.0 + m22 - m00 - m11, 0)) * 2
        q3 = np.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)

    c1 = (m00 > m11) & (m00 > m22)
    c2 = m11 > m22
    q = np.where(c0[..., None], q0, np.where(c1[..., None], q1, np.where(c2[..., None], q2, q3)))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q.astype(np.float32)
