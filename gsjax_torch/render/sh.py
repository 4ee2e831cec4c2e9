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
    return torch.clamp(sh_color_terms(sh, dirs)[1], min=0.0)


def sh_color_terms(sh: torch.Tensor, dirs: torch.Tensor):
    """eval_sh's basis [..., K] and its color before the clamp [..., 3]
    (the projection's VJP reads both)."""
    basis = sh_basis(dirs, sh.shape[-2])
    return basis, torch.sum(basis[..., :, None] * sh, dim=-2) + 0.5


def sh_basis_vjp(dirs: torch.Tensor, g_basis: torch.Tensor) -> torch.Tensor:
    """The VJP of sh_basis at unit directions dirs [..., 3] for the
    basis' gradient g_basis [..., k]: [..., 3] (each ∂B_k/∂dir as
    graphdeco's backward writes it, csrc/project.cu's sh_basis_vjp)."""
    k = g_basis.shape[-1]
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    g = [torch.zeros_like(x) for _ in range(3)]
    if k > 1:
        gb = g_basis.unbind(-1)
        g[0] = g[0] - SH_C1 * gb[3]
        g[1] = g[1] - SH_C1 * gb[1]
        g[2] = g[2] + SH_C1 * gb[2]
    if k > 4:
        c = SH_C2
        g[0] = g[0] + c[0] * y * gb[4] + c[2] * -2.0 * x * gb[6] + c[3] * z * gb[7] \
            + c[4] * 2.0 * x * gb[8]
        g[1] = g[1] + c[0] * x * gb[4] + c[1] * z * gb[5] + c[2] * -2.0 * y * gb[6] \
            + c[4] * -2.0 * y * gb[8]
        g[2] = g[2] + c[1] * y * gb[5] + c[2] * 4.0 * z * gb[6] + c[3] * x * gb[7]
    if k > 9:
        c = SH_C3
        xx, yy, zz = x * x, y * y, z * z
        g[0] = (g[0] + c[0] * 6.0 * x * y * gb[9] + c[1] * y * z * gb[10]
                + c[2] * -2.0 * x * y * gb[11] + c[3] * -6.0 * x * z * gb[12]
                + c[4] * (4.0 * zz - 3.0 * xx - yy) * gb[13] + c[5] * 2.0 * x * z * gb[14]
                + c[6] * 3.0 * (xx - yy) * gb[15])
        g[1] = (g[1] + c[0] * 3.0 * (xx - yy) * gb[9] + c[1] * x * z * gb[10]
                + c[2] * (4.0 * zz - xx - 3.0 * yy) * gb[11] + c[3] * -6.0 * y * z * gb[12]
                + c[4] * -2.0 * x * y * gb[13] + c[5] * -2.0 * y * z * gb[14]
                + c[6] * -6.0 * x * y * gb[15])
        g[2] = (g[2] + c[1] * x * y * gb[10] + c[2] * 8.0 * y * z * gb[11]
                + c[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy) * gb[12]
                + c[4] * 8.0 * x * z * gb[13] + c[5] * (xx - yy) * gb[14])
    return torch.stack(g, dim=-1)
