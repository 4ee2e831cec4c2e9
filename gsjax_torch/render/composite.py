"""Compositing helpers shared by the blend backends and the flat
backend's compositor — the PyTorch counterpart of the parts of
gsjax/render/composite.py the stream and flat backends use. The
padded-list (xla) blend waits for ROADMAP queue 1, "reference blend
path"."""

from __future__ import annotations

import torch

from gsjax_torch.core.config import RenderConfig
from gsjax_torch.render.binning import TileBins
from gsjax_torch.render.project import ProjectedSplats


def att_table(p: ProjectedSplats) -> torch.Tensor:
    """Per-splat packed attributes [N, 9]: mean2d, conic, rgb, opacity."""
    return torch.cat([p.mean2d, p.conic, p.rgb, p.opacity[:, None]], dim=-1)


def clipped_pair_stream(bins: TileBins, cfg: RenderConfig):
    """Apply the optional total-pair budget. Returns (pid_sorted [S'] i32,
    starts [T+1] i32, n_dropped)."""
    S = bins.pid_sorted.shape[0]
    cap = min(cfg.pair_cap, S) if cfg.pair_cap else S
    starts = torch.clamp(bins.tile_starts, max=cap).to(torch.int32)
    n_dropped = torch.clamp(bins.tile_starts[-1] - cap, min=0)
    return bins.pid_sorted[:cap], starts, n_dropped


def assemble_band(img_t, T_t, bins: TileBins, cfg: RenderConfig, bg=None):
    """Per-tile flat pixels [T, n_px, 3] / [T, n_px] → band image
    [band_rows·ts, tiles_x·ts, 3] and transmittance map, with the
    background weighted by the actual transmittance. `bins`: anything
    with its tiles_x and band_rows (a TileBins, a lazy FramePlan); `bg`:
    cfg.background as a [3] tensor on img_t's device, made from the host
    values when not given (a copy that waits for the stream)."""
    ts = cfg.tile_size
    tiles_x, band_rows = bins.tiles_x, bins.band_rows
    if bg is None:
        bg = torch.tensor(cfg.background, dtype=torch.float32, device=img_t.device)
    img_t = img_t + T_t[..., None] * bg
    img = img_t.reshape(band_rows, tiles_x, ts, ts, 3)
    img = img.permute(0, 2, 1, 3, 4).reshape(band_rows * ts, tiles_x * ts, 3)
    T_map = T_t.reshape(band_rows, tiles_x, ts, ts)
    T_map = T_map.permute(0, 2, 1, 3).reshape(band_rows * ts, tiles_x * ts)
    return img, T_map


def composite_tiles_flat(p: ProjectedSplats, bins: TileBins, cam, cfg: RenderConfig):
    """Composite the tile band covered by `bins` through the flat slot-
    stream kernels (render/flat.py: kernel E forward, F backward). `p` are
    the home rows the bins were built over. Returns (img [band_rows·ts,
    tiles_x·ts, 3], aux) with the stream backend's aux keys but
    n_fat_overflow, which the caller adds from the layout (as the
    reference's pipeline does)."""
    # imported here, as in the reference: flat.py builds on stream.py,
    # which builds on this module
    from gsjax_torch.render.flat import blend_slots, chunked_pair_attrs

    del cam  # the reference's signature; the bins carry the band
    pid, starts, n_dropped = clipped_pair_stream(bins, cfg)
    att_al, tile_of, cbase = chunked_pair_attrs(att_table(p), pid, starts, cfg,
                                                cfg.tile_span * cfg.tile_span)
    img_t, T_t = blend_slots(att_al, starts, cbase, tile_of, bins.ty0,
                             bins.tiles_x, bins.band_rows, cfg)
    img, T_map = assemble_band(img_t, T_t, bins, cfg)
    zero = torch.zeros((), dtype=torch.int32, device=img.device)
    aux = {
        "transmittance": T_map,
        "n_clamped": bins.n_clamped,
        "n_pairs": bins.n_pairs,
        "n_tile_overflow": zero,
        "n_pair_overflow": n_dropped + bins.n_repack_overflow,
        "n_band_overflow": zero,  # no band scratch in the port
    }
    return img, aux
