"""Headless viewer: render camera trajectories to frames — the PyTorch
counterpart of gsjax/viewer.py, the form of the reference's browser loop
(controls.update(), then renderer.render(scene, camera), once a frame;
camera/controls.py is the controls). Rendering runs under
torch.no_grad() on the device of the scene's tensors; the fade-in pass
animates as the reference's FadeInPass does."""

from __future__ import annotations

import os

import numpy as np
import torch

from gsjax_torch.camera.orbit import OrbitCamera
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.render.passes import depth_fade
from gsjax_torch.render.pipeline import render
from gsjax_torch.utils.image import write_png


def render_trajectory(g, cameras, cfg: RenderConfig = RenderConfig(),
                      out_dir=None, fade_in: bool = False,
                      fade_speed: float = 1.0, on_aux=None):
    """Render a list of cameras; returns frames [F, H, W, 3] (numpy
    float32) and writes frame_%04d.png into out_dir when given.

    fade_in is the reference's FadeInPass: the fade value advances by
    fade_speed·0.01 a frame up to 1, each frame rendering with
    depth_fade(value); once it reaches 1 the frames carry no pass.
    on_aux(aux), when given, is called with each frame's render aux (its
    overflow counters)."""
    frames = []
    fade = 0.0
    with torch.no_grad():
        for i, cam in enumerate(cameras):
            passes = ()
            if fade_in and fade < 1.0:
                fade = min(fade + fade_speed * 0.01, 1.0)
                passes = (depth_fade(fade),)
            img, aux = render(g, cam, cfg, return_aux=True, passes=passes)
            if on_aux is not None:
                on_aux(aux)
            img = img.cpu().numpy()
            frames.append(img)
            if out_dir is not None:
                os.makedirs(out_dir, exist_ok=True)
                write_png(os.path.join(out_dir, f"frame_{i:04d}.png"), img)
    return np.stack(frames)


def render_orbit(g, n_frames: int = 30, radius: float = 5.0,
                 target=(0.0, 0.0, 0.0), beta: float = 0.0,
                 cfg: RenderConfig = RenderConfig(), out_dir=None, on_aux=None,
                 **cam_kwargs):
    """Render a full orbit around the scene (on_aux: render_trajectory's)."""
    cams = OrbitCamera(radius=radius, target=target, beta=beta).trajectory(
        n_frames, **cam_kwargs
    )
    return render_trajectory(g, cams, cfg, out_dir=out_dir, on_aux=on_aux)
