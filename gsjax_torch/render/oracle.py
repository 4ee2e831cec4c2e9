"""The oracle renderer: naive O(N·pixels) rasterization in plain PyTorch —
the PyTorch counterpart of gsjax/render/oracle.py, the in-repo ground
truth every fast backend is held to.

Graphdeco's compositing semantics, exactly:
  - tile-granular support: a splat reaches a pixel iff the pixel's tile
    lies in the splat's radius rect (the candidate set the binned
    backends see; under footprint_clamp the span-clamped rect);
  - the 1/255 alpha floor and the 0.99 alpha clamp;
  - front-to-back termination: a splat that would push the transmittance
    below 1e-4 is excluded and compositing stops (sticky per pixel).

Termination in closed form: the virtual transmittance C_i = Π_{j≤i,
eligible}(1 − α_j) only shrinks, so "C_i ≥ eps" is graphdeco's sticky
`done` flag and the composite is one cumprod over the depth-sorted
splats, differentiable by autograd — the gradient oracle too. It uses the
library exp where the binned backends use fexp, as the reference does.
The [H, W, N] broadcasting is for small scenes and crops only.
"""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch.core.camera import Camera
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.core.gaussians import Gaussians
from gsjax_torch.render.common import (clamp_rect_to_span, f32_scalar, gaussian_power,
                                       tile_rect)
from gsjax_torch.render.project import ProjectedSplats, project


def render_oracle(g: Gaussians, cam: Camera, cfg: RenderConfig = RenderConfig(),
                  return_aux: bool = False):
    """Render [H, W, 3] (and an aux dict) the slow, obviously correct way,
    on the device of `g`'s tensors."""
    cam = cam.to(g.device)
    p = project(g, cam, cfg)
    return composite_oracle(p, cam, cfg, return_aux=return_aux)


def composite_oracle(p: ProjectedSplats, cam: Camera, cfg: RenderConfig,
                     return_aux: bool = False):
    """Composite projected splats `p` over every pixel of the camera."""
    H, W = cam.height, cam.width
    dev = p.depth.device
    # depth order: the full f32 depth, stable in the splat index — the
    # binned backends' (tile, depth bits, pid) order within a tile
    key = torch.where(p.valid, p.depth, f32_scalar(float("inf"), p.depth))
    order = torch.argsort(key, stable=True)
    ps = ProjectedSplats(**{f.name: getattr(p, f.name)[order]
                            for f in dataclasses.fields(p)})

    ts = cfg.tile_size
    x0, y0, x1, y1 = tile_rect(ps.mean2d, ps.radius, cfg.tiles_x(W), cfg.tiles_y(H), ts)
    if cfg.footprint_clamp:
        # the legacy span budget: the binned backends' clamp
        x0, y0, x1, y1, _ = clamp_rect_to_span(x0, y0, x1, y1, ps.mean2d, ts,
                                               cfg.tile_span)
    px = torch.arange(W, dtype=torch.float32, device=dev)
    py = torch.arange(H, dtype=torch.float32, device=dev)
    tx = (torch.arange(W, device=dev) // ts).to(torch.int32)
    ty = (torch.arange(H, device=dev) // ts).to(torch.int32)

    dx = px[None, :, None] - ps.mean2d[None, None, :, 0]  # [H, W, N]
    dy = py[:, None, None] - ps.mean2d[None, None, :, 1]
    power = gaussian_power(ps.conic[None, None, :, :], dx, dy)
    alpha = torch.minimum(ps.opacity[None, None, :] * torch.exp(power),
                          f32_scalar(cfg.alpha_clamp, power))
    cover = (
        (tx[None, :, None] >= x0[None, None, :])
        & (tx[None, :, None] < x1[None, None, :])
        & (ty[:, None, None] >= y0[None, None, :])
        & (ty[:, None, None] < y1[None, None, :])
    )
    eligible = ps.valid[None, None, :] & cover & (alpha >= cfg.alpha_min) & (power <= 0.0)
    f = torch.where(eligible, 1.0 - alpha, 1.0)  # per-splat transmittance factor
    C = torch.cumprod(f, dim=-1)  # virtual inclusive transmittance
    include = eligible & (C >= cfg.transmittance_eps)
    w = torch.where(include, (C / f) * alpha, 0.0)  # [H, W, N]
    img = torch.einsum("hwn,nc->hwc", w, ps.rgb)  # fp32: TF32 stays off
    T_final = torch.prod(torch.where(include, f, 1.0), dim=-1)
    bg = torch.tensor(cfg.background, dtype=torch.float32, device=dev)
    img = img + T_final[..., None] * bg
    if not return_aux:
        return img
    return img, {"transmittance": T_final, "n_contrib": include.sum(dim=-1),
                 "projected": p}
