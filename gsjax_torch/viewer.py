"""Headless viewer: render camera trajectories to frames — the PyTorch
counterpart of gsjax/viewer.py. Rendering runs under torch.no_grad() on
the device of the scene's tensors."""

from __future__ import annotations

import os

import numpy as np
import torch

from gsjax_torch.camera.orbit import OrbitCamera
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.render.pipeline import render
from gsjax_torch.utils.image import write_png


def render_trajectory(g, cameras, cfg: RenderConfig = RenderConfig(),
                      out_dir=None, fade_in: bool = False,
                      fade_speed: float = 1.0):
    """Render a list of cameras; returns frames [F, H, W, 3] (numpy
    float32) and writes frame_%04d.png into out_dir when given. fade_in
    (the reference's FadeInPass) waits for render/passes.py."""
    if fade_in:
        raise NotImplementedError(
            "fade_in needs render/passes.py: ROADMAP queue 1 'controls/passes'"
        )
    del fade_speed  # only read by the fade-in pass
    frames = []
    with torch.no_grad():
        for i, cam in enumerate(cameras):
            img = render(g, cam, cfg).cpu().numpy()
            frames.append(img)
            if out_dir is not None:
                os.makedirs(out_dir, exist_ok=True)
                write_png(os.path.join(out_dir, f"frame_{i:04d}.png"), img)
    return np.stack(frames)


def render_orbit(g, n_frames: int = 30, radius: float = 5.0,
                 target=(0.0, 0.0, 0.0), beta: float = 0.0,
                 cfg: RenderConfig = RenderConfig(), out_dir=None,
                 **cam_kwargs):
    """Render a full orbit around the scene."""
    cams = OrbitCamera(radius=radius, target=target, beta=beta).trajectory(
        n_frames, **cam_kwargs
    )
    return render_trajectory(g, cams, cfg, out_dir=out_dir)
