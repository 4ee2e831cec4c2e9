"""The garden-like scene: a frozen copy of
`gsjax_torch/bench/synth.py::garden_like`'s distribution."""

from __future__ import annotations

import math

import torch

from gsbench.inputs.scenes import SH_K, beta22, finish, generator


def generate(n: int, sh_degree: int, seed: int, offset: int, device) -> dict:
    """~garden-scale outdoor scan: 35% a ground plane (x, z uniform in
    ±6, y N(0.9, 0.05)), 35% a central subject (normal, sd 0.7, scaled
    1.2/0.9/1.2), 30% shrubbery (flattened directions at radius 2-7,
    lifted 0.4); log-normal scales shrunk by sqrt(n / 1.2M); opacities and
    SH as bonsai_like's."""
    gen = generator(seed, offset, device)
    k = SH_K[sh_degree]
    n_ground = int(n * 0.35)
    n_core = int(n * 0.35)
    n_shrub = n - n_ground - n_core
    z = torch.randn(n_ground + n_core * 3 + n_shrub * 3 + n * 3 + n * 4 + n * (k - 1) * 3,
                    generator=gen, device=device)
    u = torch.rand(n_ground * 2 + n_shrub + n * 3 + n * 3, generator=gen, device=device)
    zs = torch.split(z, [n_ground, n_core * 3, n_shrub * 3, n * 3, n * 4, n * (k - 1) * 3])
    us = torch.split(u, [n_ground * 2, n_shrub, n * 3, n * 3])
    gxz = us[0].view(n_ground, 2) * 12.0 - 6.0
    ground = torch.stack([gxz[:, 0], 0.9 + 0.05 * zs[0], gxz[:, 1]], dim=1)
    core = zs[1].view(n_core, 3) * 0.7 * torch.tensor([1.2, 0.9, 1.2], device=device)
    sd = zs[2].view(n_shrub, 3) * torch.tensor([1.0, 0.3, 1.0], device=device)
    sd = sd / (torch.linalg.norm(sd, dim=-1, keepdim=True) + 1e-9)
    shrub = (sd * (2.0 + 5.0 * us[1])[:, None]
             + torch.tensor([0.0, 0.4, 0.0], device=device))
    means = torch.cat([ground, core, shrub])
    size_shift = -0.5 * math.log(n / 1_200_000)
    log_scales = zs[3].view(n, 3) * 0.8 + (-4.6 + size_shift)
    opac = beta22(us[2].view(n, 3)) * 0.98 + 0.01
    sh = torch.empty((n, k, 3), device=device)
    sh[:, 0, :] = us[3].view(n, 3) * 2.6 - 0.8
    sh[:, 1:, :] = zs[5].view(n, k - 1, 3) * 0.25
    return finish(means, log_scales, zs[4].view(n, 4), opac, sh)
