"""Synthetic benchmark scenes — the PyTorch counterpart of
gsjax/bench/synth.py. The numpy draws are the reference's, call for call,
so both packages build the same arrays from the same seed."""

from __future__ import annotations

import numpy as np

from gsjax_torch.core.camera import Camera
from gsjax_torch.core.gaussians import Gaussians


def bonsai_like(n: int = 1_200_000, seed: int = 0, sh_degree: int = 0,
                device="cuda") -> Gaussians:
    """~Bonsai-scale scene: dense central object + sparse surroundings,
    the surrounding shell inside the orbit radius and the log-normal
    scale tail clamped at 0.04 (see the reference's docstring)."""
    rng = np.random.default_rng(seed)
    n_core = int(n * 0.8)
    n_bg = n - n_core
    core = rng.normal(0.0, 0.6, (n_core, 3)) * np.array([1.0, 0.8, 1.0])
    bg_dir = rng.normal(size=(n_bg, 3))
    bg_dir /= np.linalg.norm(bg_dir, axis=-1, keepdims=True)
    bg = bg_dir * rng.uniform(1.5, 3.4, (n_bg, 1))
    means = np.concatenate([core, bg]).astype(np.float32)
    scales = np.minimum(
        np.exp(rng.normal(-4.6, 0.8, (n, 3))), 0.04
    ).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    opac = rng.beta(2.0, 2.0, n).astype(np.float32) * 0.98 + 0.01
    k = {0: 1, 1: 4, 2: 9, 3: 16}[sh_degree]
    sh = (rng.normal(0, 0.25, (n, k, 3))).astype(np.float32)
    sh[:, 0, :] = rng.uniform(-0.8, 1.8, (n, 3))
    return Gaussians.from_activated(
        means=means, scales=scales, quats=q, opacities=opac, sh=sh,
        device=device,
    )


def garden_like(n: int = 5_000_000, seed: int = 1, sh_degree: int = 2,
                device="cuda") -> Gaussians:
    """~garden-scale outdoor scan: ground plane + central subject +
    shrubbery, splat sizes shrunk as 1/sqrt(n/1.2M)."""
    rng = np.random.default_rng(seed)
    n_ground = int(n * 0.35)
    n_core = int(n * 0.35)
    n_shrub = n - n_ground - n_core
    gx = rng.uniform(-6.0, 6.0, (n_ground, 1))
    gz = rng.uniform(-6.0, 6.0, (n_ground, 1))
    gy = rng.normal(0.9, 0.05, (n_ground, 1))
    ground = np.concatenate([gx, gy, gz], axis=1)
    core = rng.normal(0.0, 0.7, (n_core, 3)) * np.array([1.2, 0.9, 1.2])
    sd = rng.normal(size=(n_shrub, 3)) * np.array([1.0, 0.3, 1.0])
    sd /= np.linalg.norm(sd, axis=-1, keepdims=True) + 1e-9
    shrub = sd * rng.uniform(2.0, 7.0, (n_shrub, 1)) + np.array([0.0, 0.4, 0.0])
    means = np.concatenate([ground, core, shrub]).astype(np.float32)
    size_shift = -0.5 * np.log(n / 1_200_000)
    scales = np.exp(rng.normal(-4.6 + size_shift, 0.8, (n, 3))).astype(
        np.float32
    )
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    opac = rng.beta(2.0, 2.0, n).astype(np.float32) * 0.98 + 0.01
    k = {0: 1, 1: 4, 2: 9, 3: 16}[sh_degree]
    sh = (rng.normal(0, 0.25, (n, k, 3))).astype(np.float32)
    sh[:, 0, :] = rng.uniform(-0.8, 1.8, (n, 3))
    return Gaussians.from_activated(
        means=means, scales=scales, quats=q, opacities=opac, sh=sh,
        device=device,
    )


def bench_camera(width: int = 1920, height: int = 1080, device="cuda") -> Camera:
    """1080p camera looking at the synthetic object (view 0 of the bench
    orbit)."""
    return Camera.look_at(
        position=(0.0, -0.6, -4.0),
        target=(0.0, 0.0, 0.0),
        fx=1600.0,
        fy=1600.0,
        width=width,
        height=height,
        device=device,
    )
