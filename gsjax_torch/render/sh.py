"""Spherical-harmonics color, degree 0-3 — the PyTorch counterpart of
gsjax/render/sh.py. Colors are max(Σ coeffs·basis + 0.5, 0)."""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def sh_basis(dirs: torch.Tensor, k: int) -> torch.Tensor:
    """Real SH basis values [..., k] for unit directions [..., 3],
    k ∈ {1, 4, 9, 16}, in graphdeco's coefficient order."""
    out = [torch.full(dirs.shape[:-1], SH_C0, dtype=dirs.dtype, device=dirs.device)]
    if k > 1:
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if k > 4:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if k > 9:
        out += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return torch.stack(out, dim=-1)


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """sh [..., K, 3], dirs [..., 3] unit view directions → colors
    [..., 3], clamped at 0 after the +0.5 offset."""
    basis = sh_basis(dirs, sh.shape[-2])
    rgb = torch.sum(basis[..., :, None] * sh, dim=-2) + 0.5
    return torch.clamp(rgb, min=0.0)
