"""The render entry point — the PyTorch counterpart of
gsjax/render/pipeline.py: project → home layout (fat-splat split) →
home-anchored bins → blend.

Backends (the hand-written CUDA kernels on a CUDA device, their plain
PyTorch versions on the CPU; both differentiable, with the home gather's
segment-sum VJP):
  stream — the gather-free stream blend: kernels C forward, D backward
  pallas — the flat slot-stream blend (render/flat.py): the pairs'
           attributes gathered into chunk-aligned slots, kernels E
           forward, F backward, the gather's scatter-set VJP. The name is
           gsjax's, so configurations carry across; the port has no
           Pallas
  auto   — stream on every device
  oracle, xla — not ported yet (NotImplementedError names the ROADMAP
           item)
"""

from __future__ import annotations

from gsjax_torch.core.camera import Camera
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.core.gaussians import Gaussians
from gsjax_torch.render.binning import build_tile_bins
from gsjax_torch.render.composite import composite_tiles_flat
from gsjax_torch.render.homesort import build_home_layout
from gsjax_torch.render.project import project
from gsjax_torch.render.stream import composite_tiles_stream

_NOT_PORTED = {
    "oracle": "ROADMAP queue 1 'oracle + xla backend'",
    "xla": "ROADMAP queue 1 'oracle + xla backend'",
}


def _resolve_backend(cfg: RenderConfig) -> str:
    backend = "stream" if cfg.backend == "auto" else cfg.backend
    if backend in _NOT_PORTED:
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet: {_NOT_PORTED[backend]}"
        )
    if backend not in ("stream", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def _project_any(g, cam: Camera, cfg: RenderConfig):
    """project() for Gaussians or BandedGaussians (core/banded.py: each
    group evaluates only its own SH degree)."""
    from gsjax_torch.core.banded import BandedGaussians, project_banded

    if isinstance(g, BandedGaussians):
        return project_banded(g, cam, cfg)
    return project(g, cam, cfg)


def render(g: Gaussians, cam: Camera, cfg: RenderConfig = RenderConfig(),
           return_aux: bool = False, passes=()):
    """Render an [H, W, 3] image on the device of `g`'s tensors (the
    camera's tensors move there). Differentiable with respect to every
    Gaussians field: autograd through projection and SH, the home
    gather's VJP (copy rows of fat splats sum onto their parents) and
    the blend's hand-written backward (kernel D, or F with the flat
    backend, on the card). `g` may be a BandedGaussians (each group
    projected at its own SH degree). `passes` (post-projection transforms) are not
    ported yet and must be empty."""
    backend = _resolve_backend(cfg)
    if passes:
        raise NotImplementedError(
            "render passes are not ported yet: ROADMAP queue 1 'controls/passes'"
        )
    if cfg.footprint_clamp:
        raise NotImplementedError(
            "footprint_clamp=True bins through the legacy anchor, which "
            "waits for ROADMAP queue 1 'oracle + xla backend'"
        )
    cam = cam.to(g.device)
    p = _project_any(g, cam, cfg)
    p, layout = build_home_layout(p, cam, cfg)
    bins = build_tile_bins(p, cam, cfg, anchor="home", layout=layout)
    if backend == "stream":
        img, aux = composite_tiles_stream(p, layout, bins, cam, cfg)
    else:
        img, aux = composite_tiles_flat(p, bins, cam, cfg)
        aux["n_fat_overflow"] = layout.n_fat_overflow
    img = img[: cam.height, : cam.width]
    aux["transmittance"] = aux["transmittance"][: cam.height, : cam.width]
    if return_aux:
        aux["projected"] = p
        return img, aux
    return img
