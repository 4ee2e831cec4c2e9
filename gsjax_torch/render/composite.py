"""Compositing helpers shared by the blend backends — the PyTorch
counterpart of the parts of gsjax/render/composite.py the stream backend
uses. The padded-list (xla) blend waits for ROADMAP queue 1, "reference
blend path"."""

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


def assemble_band(img_t, T_t, bins: TileBins, cfg: RenderConfig):
    """Per-tile flat pixels [T, n_px, 3] / [T, n_px] → band image
    [band_rows·ts, tiles_x·ts, 3] and transmittance map, with the
    background weighted by the actual transmittance."""
    ts = cfg.tile_size
    tiles_x, band_rows = bins.tiles_x, bins.band_rows
    bg = torch.tensor(cfg.background, dtype=torch.float32, device=img_t.device)
    img_t = img_t + T_t[..., None] * bg
    img = img_t.reshape(band_rows, tiles_x, ts, ts, 3)
    img = img.permute(0, 2, 1, 3, 4).reshape(band_rows * ts, tiles_x * ts, 3)
    T_map = T_t.reshape(band_rows, tiles_x, ts, ts)
    T_map = T_map.permute(0, 2, 1, 3).reshape(band_rows * ts, tiles_x * ts)
    return img, T_map
