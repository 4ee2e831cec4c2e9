"""The bonsai-like scene: a frozen copy of
`gsjax_torch/bench/synth.py::bonsai_like`'s distribution."""

from __future__ import annotations

import math

import torch

from gsbench.inputs.scenes import SH_K, beta22, finish, generator


def generate(n: int, sh_degree: int, seed: int, offset: int, device) -> dict:
    """~Bonsai-scale scene: 80% a dense central object (normal, sd 0.6,
    y squashed by 0.8), 20% a shell at radius 1.5-3.4; log-normal scales
    (mean log -4.6, sd 0.8) clamped at 0.04; Beta(2, 2) opacities scaled
    into [0.01, 0.99]; SH DC uniform in [-0.8, 1.8], higher bands N(0,
    0.25)."""
    gen = generator(seed, offset, device)
    k = SH_K[sh_degree]
    n_core = int(n * 0.8)
    n_bg = n - n_core
    z = torch.randn(n_core * 3 + n_bg * 3 + n * 3 + n * 4 + n * (k - 1) * 3,
                    generator=gen, device=device)
    u = torch.rand(n_bg + n * 3 + n * 3, generator=gen, device=device)
    zs = torch.split(z, [n_core * 3, n_bg * 3, n * 3, n * 4, n * (k - 1) * 3])
    us = torch.split(u, [n_bg, n * 3, n * 3])
    core = zs[0].view(n_core, 3) * 0.6 * torch.tensor([1.0, 0.8, 1.0], device=device)
    bg_dir = zs[1].view(n_bg, 3)
    bg_dir = bg_dir / torch.linalg.norm(bg_dir, dim=-1, keepdim=True)
    bg = bg_dir * (1.5 + 1.9 * us[0])[:, None]
    means = torch.cat([core, bg])
    log_scales = torch.clamp(zs[2].view(n, 3) * 0.8 - 4.6, max=math.log(0.04))
    opac = beta22(us[1].view(n, 3)) * 0.98 + 0.01
    sh = torch.empty((n, k, 3), device=device)
    sh[:, 0, :] = us[2].view(n, 3) * 2.6 - 0.8
    sh[:, 1:, :] = zs[4].view(n, k - 1, 3) * 0.25
    return finish(means, log_scales, zs[3].view(n, 4), opac, sh)
