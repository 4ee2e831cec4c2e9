"""The render entry point — the PyTorch counterpart of
gsjax/render/pipeline.py: project → (passes) → layout → bins → blend.

Backends:
  oracle — O(N·pixels) plain PyTorch ground truth (render/oracle.py)
  xla    — the padded-list blend (render/composite.py), plain PyTorch,
           differentiated by autograd; exact mode bins through kernels A
           and B
  stream — the gather-free stream blend: kernels C forward, D backward
  pallas — the flat slot-stream blend (render/flat.py): the pairs'
           attributes gathered into chunk-aligned slots, kernels E
           forward, F backward, the gather's scatter-set VJP. The name is
           gsjax's, so configurations carry across; the port has no
           Pallas
  auto   — stream on every device

Exact-footprint mode (the default) splits fat splats into home rows
(render/homesort.py, kernel A) and bins them by the home anchor (kernel
B). Legacy mode (footprint_clamp=True) clamps each footprint to the span:
stream bins the legacy home layout by the home anchor, xla and pallas the
projected splats by the rect anchor, both in plain PyTorch. On a CUDA
device the kernels run (there is no fallback); on the CPU their plain
versions do.
"""

from __future__ import annotations

from gsjax_torch import trace
from gsjax_torch.core.camera import Camera
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.core.gaussians import Gaussians
from gsjax_torch.render.binning import build_tile_bins
from gsjax_torch.render.composite import composite_tiles, composite_tiles_flat
from gsjax_torch.render.homesort import build_home_layout
from gsjax_torch.render.oracle import composite_oracle, render_oracle
from gsjax_torch.render.project import project
from gsjax_torch.render.stream import composite_tiles_stream


def _resolve_backend(cfg: RenderConfig) -> str:
    backend = "stream" if cfg.backend == "auto" else cfg.backend
    if backend not in ("oracle", "xla", "stream", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


@trace.spanned("project")
def _project_any(g, cam: Camera, cfg: RenderConfig):
    """project() for Gaussians or BandedGaussians (core/banded.py: each
    group evaluates only its own SH degree)."""
    from gsjax_torch.core.banded import BandedGaussians, project_banded

    if isinstance(g, BandedGaussians):
        return project_banded(g, cam, cfg)
    return project(g, cam, cfg)


@trace.spanned("render")
def render(g: Gaussians, cam: Camera, cfg: RenderConfig = RenderConfig(),
           return_aux: bool = False, passes=()):
    """Render an [H, W, 3] image on the device of `g`'s tensors (the
    camera's tensors move there). Differentiable with respect to every
    Gaussians field and the camera's: autograd through projection and SH,
    the home gather's VJP (copy rows of fat splats sum onto their
    parents) and the blend's backward (kernel D, or F with the flat
    backend, on the card; autograd with oracle and xla). `g` may be a
    BandedGaussians (each group projected at its own SH degree). `passes`
    are post-projection transforms (render/passes.py), applied in order
    before the layout."""
    backend = _resolve_backend(cfg)
    cam = cam.to(g.device)
    if backend == "oracle":
        from gsjax_torch.core.banded import BandedGaussians

        if not passes and not isinstance(g, BandedGaussians):
            return render_oracle(g, cam, cfg, return_aux=return_aux)
        p = _project_any(g, cam, cfg)
        for ps in passes:
            p = ps(p, cam, cfg)
        return composite_oracle(p, cam, cfg, return_aux=return_aux)
    p = _project_any(g, cam, cfg)
    for ps in passes:
        p = ps(p, cam, cfg)
    if backend == "stream":
        # the legacy home layout under the clamp: home = the mean's tile
        p, layout = build_home_layout(p, cam, cfg)
        bins = build_tile_bins(p, cam, cfg, anchor="home", layout=layout)
        img, aux = composite_tiles_stream(p, layout, bins, cam, cfg)
    else:
        if cfg.footprint_clamp:  # the span-clamped rects of the splats themselves
            bins = build_tile_bins(p, cam, cfg)
            fat_ovf = None
        else:
            p, layout = build_home_layout(p, cam, cfg)
            bins = build_tile_bins(p, cam, cfg, anchor="home", layout=layout)
            fat_ovf = layout.n_fat_overflow
        if backend == "xla":
            img, aux = composite_tiles(p, bins, cam, cfg)
        else:
            img, aux = composite_tiles_flat(p, bins, cam, cfg)
        if fat_ovf is not None:
            aux["n_fat_overflow"] = fat_ovf
    img = img[: cam.height, : cam.width]
    aux["transmittance"] = aux["transmittance"][: cam.height, : cam.width]
    if return_aux:
        aux["projected"] = p
        return img, aux
    return img
