"""Tile compositing — the PyTorch counterpart of
gsjax/render/composite.py: the padded-list blend of the `xla` backend
(plain PyTorch on every device, differentiated by autograd) and the
helpers the stream and flat backends share.

The padded-list blend walks each tile's depth-ordered pair list in
chunks of cfg.chunk, all tiles at once, with two carries per pixel: the
virtual transmittance C (the product over every eligible splat, which
makes termination sticky) and the actual T_act (over included splats
only, which weights the background).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from gsjax_torch import trace
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.render.binning import TileBins
from gsjax_torch.render.common import f32_scalar, gaussian_power
from gsjax_torch.render.fastmath import fexp
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


def build_padded_lists(p: ProjectedSplats, bins: TileBins, cfg: RenderConfig):
    """Gather per-pair attributes into per-tile padded lists: (att [T,
    cap, 9] f32, counts [T] i32), cap = cfg.tile_list_cap. A tile's pairs
    beyond the cap are dropped far to near (the caller counts them from
    bins.tile_counts); dead lanes carry zero attributes. Differentiable
    through the gather."""
    cap = cfg.tile_list_cap
    k_slots = cfg.tile_span * cfg.tile_span
    n = p.depth.shape[0]
    dev = p.depth.device
    counts = torch.clamp(bins.tile_counts, max=cap)
    lane = torch.arange(cap, dtype=torch.int32, device=dev)
    # the stream holds only live pairs; one sentinel pid (sid = N) past
    # its end serves the lanes beyond it
    s = bins.pid_sorted.shape[0]
    pid = torch.cat([bins.pid_sorted,
                     torch.full((1,), n * k_slots, dtype=torch.int32, device=dev)])
    idx = torch.clamp(bins.tile_starts[:-1, None] + lane[None, :], max=s)
    sid = (pid[idx.to(torch.int64)] // k_slots).to(torch.int64)
    live = (lane[None, :] < counts[:, None]) & (sid < n)
    sid = torch.where(live, sid, 0)
    att = torch.where(live[:, :, None], att_table(p)[sid], 0.0)
    return att, counts


def _blend_chunk(C, T_act, img, att_c, valid_c, px, py, cfg: RenderConfig):
    """One chunk of every tile: carries C, T_act [T, n_px], img [T, n_px,
    3]; att_c [T, chunk, 9], valid_c [T, chunk]; pixel centres px, py
    [T, n_px]."""
    dx = px[:, :, None] - att_c[:, None, :, 0]  # [T, n_px, chunk]
    dy = py[:, :, None] - att_c[:, None, :, 1]
    power = gaussian_power(att_c[:, None, :, 2:5], dx, dy)
    alpha = torch.minimum(att_c[:, None, :, 8] * fexp(power),
                          f32_scalar(cfg.alpha_clamp, att_c))
    eligible = valid_c[:, None, :] & (alpha >= cfg.alpha_min) & (power <= 0.0)
    f = torch.where(eligible, 1.0 - alpha, 1.0)
    Cc = C[:, :, None] * torch.cumprod(f, dim=-1)  # virtual inclusive T
    include = eligible & (Cc >= cfg.transmittance_eps)
    w = torch.where(include, (Cc / f) * alpha, 0.0)
    img = img + torch.bmm(w, att_c[:, :, 5:8])  # fp32: TF32 stays off
    T_act = T_act * torch.prod(torch.where(include, f, 1.0), dim=-1)
    return Cc[:, :, -1], T_act, img


def blend_padded(att, counts, ty0: int, tiles_x: int, band_rows: int,
                 cfg: RenderConfig):
    """Front-to-back composite of padded tile lists (att [T, cap, 9],
    counts [T]): (img [T, n_px, 3], T_act [T, n_px]), each tile's pixels
    row-major. The chunks run in order, every tile at once (the
    reference's vmap); under autograd each chunk is recomputed in the
    backward (torch.utils.checkpoint, the reference's jax.checkpoint), so
    only the carries are kept."""
    ts, cap, chunk = cfg.tile_size, cfg.tile_list_cap, cfg.chunk
    if cap % chunk:
        raise ValueError("tile_list_cap must be a multiple of chunk")
    dev = att.device
    n_tiles = tiles_x * band_rows
    n_px = ts * ts
    t_ids = torch.arange(n_tiles, device=dev)
    pix = torch.arange(n_px, device=dev)
    px = ((t_ids % tiles_x) * ts)[:, None].to(torch.float32) + (pix % ts).to(torch.float32)
    py = ((ty0 + t_ids // tiles_x) * ts)[:, None].to(torch.float32) + (pix // ts).to(
        torch.float32)
    lane = torch.arange(chunk, device=dev)
    C = torch.ones((n_tiles, n_px), dtype=torch.float32, device=dev)
    T_act = torch.ones_like(C)
    img = torch.zeros((n_tiles, n_px, 3), dtype=torch.float32, device=dev)
    for k in range(cap // chunk):
        att_c = att[:, k * chunk:(k + 1) * chunk]
        valid_c = (k * chunk + lane)[None, :] < counts[:, None]
        if torch.is_grad_enabled():
            C, T_act, img = checkpoint(_blend_chunk, C, T_act, img, att_c, valid_c, px,
                                       py, cfg, use_reentrant=False)
        else:
            C, T_act, img = _blend_chunk(C, T_act, img, att_c, valid_c, px, py, cfg)
    return img, T_act


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
        trace.host_sync(img_t)
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


def composite_tiles(p: ProjectedSplats, bins: TileBins, cam, cfg: RenderConfig):
    """Composite the tile band covered by `bins` through the padded-list
    blend (the `xla` backend). Returns (img [band_rows·ts, tiles_x·ts,
    3], aux) with the reference's aux keys; n_tile_overflow counts the
    pairs beyond each tile's tile_list_cap, which are dropped."""
    del cam  # the reference's signature; the bins carry the band
    att, counts = build_padded_lists(p, bins, cfg)
    img_t, T_t = blend_padded(att, counts, bins.ty0, bins.tiles_x, bins.band_rows, cfg)
    img, T_map = assemble_band(img_t, T_t, bins, cfg)
    aux = {
        "transmittance": T_map,
        "n_clamped": bins.n_clamped,
        "n_pairs": bins.n_pairs,
        "n_tile_overflow": torch.clamp(bins.tile_counts - cfg.tile_list_cap, min=0).sum(),
    }
    return img, aux
