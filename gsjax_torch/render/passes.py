"""Render passes — the PyTorch counterpart of gsjax/render/passes.py.

A pass transforms the projected splats between projection and the layout:
`render(..., passes=[...])` applies them in order, each `(p, cam, cfg) ->
ProjectedSplats`. The one the reference ships is its fade-in: new scenes
pop in by growing each splat's screen-space footprint from 0 to full
size, near splats first.

Divisions go by 0-d tensors (common.f32_scalar), not Python floats:
torch computes `float / tensor` as a reciprocal times the float, and on
the card divides by a float by multiplying with its reciprocal, both of
which round differently from the reference's true division.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gsjax_torch.render.common import f32_scalar
from gsjax_torch.render.project import ProjectedSplats


def depth_fade(value: float, near: float = 0.1, far: float = 100.0, width: float = 0.1):
    """The reference's depth-fade schedule: a pass that scales each
    splat's footprint by clamp((value − (d̂ − w)) / 2w, 0, 1), d̂ the
    normalised device depth. Drive `value` from 0 to 1 over frames
    (viewer.render_trajectory(fade_in=True) steps it by speed·0.01)."""

    def apply(p: ProjectedSplats, cam, cfg) -> ProjectedSplats:
        depth_norm = torch.clamp(p.depth / f32_scalar(max(cam.far, 1e-6), p.depth), 0.0, 1.0)
        nd = f32_scalar(2.0 * near, p.depth) / (far + near - depth_norm * (far - near))
        start = torch.clamp(nd - width, min=0.0)
        end = torch.clamp(nd + width, max=1.0)
        s = torch.clamp((value - start) / torch.clamp(end - start, min=1e-6), 0.0, 1.0)
        # scaling the footprint scales cov2d by s², so the conic by 1/s²
        # and the radius by s
        s_safe = torch.clamp(s, min=1e-6)
        return dataclasses.replace(
            p,
            conic=p.conic / (s_safe * s_safe)[:, None],
            radius=p.radius * s,
            valid=p.valid & (s > 0.0),
        )

    return apply


def splat_scale(factor: float):
    """A pass that scales every splat's screen-space footprint uniformly."""

    def apply(p: ProjectedSplats, cam, cfg) -> ProjectedSplats:
        f = np.float32(factor)
        return dataclasses.replace(
            p,
            conic=p.conic / f32_scalar(f * f, p.conic),
            radius=p.radius * f32_scalar(f, p.radius),
        )

    return apply
