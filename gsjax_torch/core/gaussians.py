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


_SH_K_FOR_DEGREE = {0: 1, 1: 4, 2: 9, 3: 16}
FIELDS = ("means", "log_scales", "quats", "sh", "opacity_logits")


class Gaussians(nn.Module):
    """Each field is an nn.Parameter (a leaf an optimizer steps), except a
    tensor computed from other tensors under autograd, which is kept as
    it is. A Parameter passed in is shared under autograd and copied under
    torch.no_grad(). So a derived scene (with_sh_degree, pad_to, slice,
    concat, core/transforms) stays differentiable back to its source's
    parameters, as jax.grad reaches through gsjax's derived pytrees, and
    one made under torch.no_grad() (an edit) holds parameters of its own."""

    def __init__(self, means, log_scales, quats, sh, opacity_logits):
        super().__init__()
        for name, t in zip(FIELDS, (means, log_scales, quats, sh, opacity_logits)):
            if isinstance(t, nn.Parameter) and not torch.is_grad_enabled():
                t = nn.Parameter(t.detach().clone())
            elif not isinstance(t, nn.Parameter) and t.grad_fn is None:
                t = nn.Parameter(t)
            setattr(self, name, t)

    @property
    def device(self) -> torch.device:
        return self.means.device

    @property
    def n(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        return {1: 0, 4: 1, 9: 2, 16: 3}[self.sh.shape[1]]

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

    def covariances(self) -> torch.Tensor:
        """[N, 3, 3] world-space covariances Σ = M Mᵀ, M = R·diag(S)."""
        M = self.rotation_matrices() * self.scales[:, None, :]
        return M @ M.transpose(-1, -2)

    # -- shape utilities ----------------------------------------------------

    def _fields(self):
        return [getattr(self, f) for f in FIELDS]

    def with_sh_degree(self, degree: int) -> "Gaussians":
        """Zero-pad or truncate the SH coefficients to `degree`."""
        k = _SH_K_FOR_DEGREE[degree]
        cur = self.sh.shape[1]
        if cur == k:
            return self
        if cur > k:
            sh = self.sh[:, :k].clone()
        else:
            sh = torch.cat([self.sh, self.sh.new_zeros((self.n, k - cur, 3))], dim=1)
        return Gaussians(self.means, self.log_scales, self.quats, sh, self.opacity_logits)

    def pad_to(self, n: int) -> "Gaussians":
        """Pad with fully transparent splats (static-shape batching)."""
        if n < self.n:
            raise ValueError(f"pad_to({n}) < n={self.n}")
        extra = n - self.n
        if extra == 0:
            return self

        def pad(x, fill=0.0):
            return torch.cat([x, x.new_full((extra,) + tuple(x.shape[1:]), fill)])

        quats = torch.cat([self.quats, self.quats.new_tensor([1.0, 0.0, 0.0, 0.0])
                           .expand(extra, 4)])
        return Gaussians(pad(self.means), pad(self.log_scales, -10.0), quats,
                         pad(self.sh), pad(self.opacity_logits, -30.0))

    def slice(self, start: int, stop: int) -> "Gaussians":
        return Gaussians(*(x[start:stop].clone() for x in self._fields()))

    def concat(self, other: "Gaussians") -> "Gaussians":
        if self.sh.shape[1] != other.sh.shape[1]:
            d = max(self.sh_degree, other.sh_degree)
            return self.with_sh_degree(d).concat(other.with_sh_degree(d))
        return Gaussians(*(torch.cat([a, b]) for a, b in zip(self._fields(), other._fields())))


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
