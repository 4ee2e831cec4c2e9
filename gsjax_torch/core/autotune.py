"""Occupancy pre-pass: size the static budgets from one measured pass
over the actual (scene, camera) pair — the PyTorch counterpart of
gsjax/core/autotune.py.

The measuring pass is the cheap prefix of the render: project → home
layout (kernel A) → pair expansion (kernel B; it writes only the live
pairs, so its count is the live-pair count). No sort, no blend. The
counts come to the host once per view. derive_caps then returns the
config with every budget the port keeps sized at `slack` headroom, by
gsjax's arithmetic:

  * fat_cap / fat_live_cap — copy enumeration / live copy rows
  * pair_cap               — live pairs + the repack grid's 128-pair pad
  * repack_w / repack_rows — gsjax's greedy row packing simulated on the
                             measured per-tile candidate totals. Inert in
                             the port (one stable sort, no repack grid),
                             kept because pair_cap counts 128 pairs a row
                             and a config moves between the two packages
                             unchanged

A load-time step: call it before rendering or training, never inside a
step. For the tile-sharded path (parallel/render_sharded.py),
derive_row_cuts splits the tile rows into bands of equal candidate mass
and derive_shard_caps sizes the bands' prefilter, slice and pair budgets
from the same measured pass.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gsjax_torch.core.config import RenderConfig
from gsjax_torch.render.binning import expand_inputs, expand_live_pairs_plain, launch_expand
from gsjax_torch.render.common import tile_rect
from gsjax_torch.render.homesort import build_home_layout
from gsjax_torch.render.pipeline import _project_any


def _ceil(a, b):
    return -(-a // b)


def _round_up(x, m):
    return _ceil(int(x), m) * m


def _live_pairs(ph, layout, tiles_x: int, tiles_y: int, cfg: RenderConfig):
    """Kernel B's live-pair count over the whole image, a 0-d tensor on
    the device (the plain expansion on the CPU), with no host read."""
    if ph.depth.device.type == "cpu":
        pid, _ = expand_live_pairs_plain(ph, layout, 0, tiles_y, tiles_x, cfg)
        return torch.tensor(pid.shape[0])
    _, _, count = launch_expand(*expand_inputs(ph, layout, cfg), 0, tiles_y, tiles_x,
                                cfg.tile_size, cfg.tile_span)
    return count


@torch.no_grad()
def _measure_pass(g, cam, cfg: RenderConfig) -> torch.Tensor:
    """Device half of measure_occupancy: [seg_starts (T+2), n_valid,
    n_fat_overflow, n_copies, n_pairs, n_live_prim] as one int64 tensor
    on g's device."""
    tiles_x, tiles_y = cfg.tiles_x(cam.width), cfg.tiles_y(cam.height)
    cam = cam.to(g.device)
    p = _project_any(g, cam, cfg)
    # live PRIMARY count, before the layout (build_home_layout's `on`):
    # n_valid counts live primaries + live copies, so the live-copy demand
    # is n_valid - n_live_prim — not n_valid - n, which undercounts it
    # (even to 0) whenever part of the scene is off-frustum
    x0, y0, x1, y1 = tile_rect(p.mean2d, p.radius, tiles_x, tiles_y, cfg.tile_size)
    n_live_prim = (p.valid & (x1 > x0) & (y1 > y0)).sum()
    ph, layout = build_home_layout(p, cam, cfg)
    n_pairs = _live_pairs(ph, layout, tiles_x, tiles_y, cfg)
    counts = [layout.n_valid, layout.n_fat_overflow, layout.n_copies, n_pairs, n_live_prim]
    return torch.cat([layout.seg_starts.to(torch.int64),
                      torch.stack([c.to(torch.int64).to(ph.depth.device) for c in counts])])


def measure_occupancy(g, cam, cfg: RenderConfig) -> dict:
    """One measuring pass: a dict of host-side occupancy facts (n,
    tiles_x / tiles_y, seg [T+2], cand [T], n_valid, n_fat_overflow,
    n_copies, n_pairs, n_live_prim), read from the device at once."""
    tiles_x, tiles_y = cfg.tiles_x(cam.width), cfg.tiles_y(cam.height)
    out = _measure_pass(g, cam, cfg).cpu().numpy()
    T = tiles_x * tiles_y
    seg = out[: T + 2]
    n_valid, fat_ovf, n_copies, n_pairs, n_live_prim = (int(v) for v in out[T + 2:])

    # per-tile candidate totals (live + culled expansion slots of the
    # tile's span² source segments), vectorized on the host
    tau = np.arange(T, dtype=np.int64)
    cand = np.zeros(T, np.int64)
    for c in range(cfg.tile_span * cfg.tile_span):
        dy = c // cfg.tile_span - cfg.tile_span // 2
        dx = c % cfg.tile_span - cfg.tile_span // 2
        s = tau - dy * tiles_x - dx
        cand += seg[np.clip(s + 1, 0, T)] - seg[np.clip(s, 0, T)]

    return {"n": g.n, "tiles_x": tiles_x, "tiles_y": tiles_y, "seg": seg, "cand": cand,
            "n_valid": n_valid, "n_fat_overflow": fat_ovf, "n_copies": n_copies,
            "n_pairs": n_pairs, "n_live_prim": n_live_prim}


def _simulate_greedy_rows(cand, w_eff: int) -> int:
    """Rows gsjax's greedy packing needs for the per-tile candidate
    totals: a tile starts a new row when it would overfill a non-empty
    one (a single tile > w_eff overflows, counted at render)."""
    rows = fill = 0
    for c in cand.tolist():
        if fill + c > w_eff and fill > 0:
            rows += 1
            fill = 0
        fill += c
    return rows + (1 if fill > 0 else 0)


def derive_caps(g, cam, cfg: RenderConfig = RenderConfig(), slack: float = 1.2,
                ms=None) -> RenderConfig:
    """Measure the scene's occupancy and return `cfg` with fat_cap,
    fat_live_cap, pair_cap, repack_w and repack_rows sized at `slack`
    headroom. The measuring pass runs at cfg's own fat caps; if those
    overflow, raise (start from a larger base).

    `cam` may be a list of cameras (an orbit): every budget is then sized
    for the worst view. `ms` (a list of measure_occupancy dicts) skips
    measuring.

    gsjax's band-scratch derivation (stream_band_cap, stream_block_tiles)
    exists for TPU VMEM, and can raise on a scene the port renders: it is
    left out, and those two fields pass through unchanged."""
    if ms is None:
        cams = cam if isinstance(cam, (list, tuple)) else [cam]
        ms = [measure_occupancy(g, c, cfg) for c in cams]
    for m in ms:
        if m["n_fat_overflow"] > 0:
            raise ValueError(
                f"measuring pass overflowed the base fat budgets "
                f"(n_fat_overflow={m['n_fat_overflow']}); raise fat_cap / "
                f"fat_max_blocks on the base config and re-derive")

    # live copies = n_valid - live primaries; the enumeration cap covers
    # the measured pre-cull copy demand, below 2^24 (the copy slots ride
    # kernel A as f32 values)
    live_copies = max(max(m["n_valid"] - m["n_live_prim"], 0) for m in ms)
    fat_live_cap = _round_up(max(int(live_copies * slack), 4096), 4096)
    fat_cap = min(_round_up(max(int(max(m["n_copies"] for m in ms) * slack), 8192), 8192),
                  (1 << 24) - 8192)

    # the repack grid: W holds the densest tile + block slack; rows from
    # the greedy simulation (worst view)
    k_slots = cfg.tile_span * cfg.tile_span
    blk_slack = k_slots * 2 * 127 + 128
    w = max(cfg.repack_w,
            _round_up(int(max(m["cand"].max() for m in ms)) + blk_slack + 1024, 1024))
    rows_true = max(_simulate_greedy_rows(m["cand"], w - blk_slack) for m in ms)
    repack_rows = int(rows_true * slack) + 2

    # pair budget: live pairs + the rows' 128-padding
    pair_cap = _round_up(int(max(m["n_pairs"] for m in ms) * slack) + 128 * repack_rows, 128)
    return dataclasses.replace(cfg, fat_cap=fat_cap, fat_live_cap=fat_live_cap,
                               pair_cap=pair_cap, repack_w=w, repack_rows=repack_rows)


# --------------------------------------------------------------------------
# the tile-sharded path's bands and budgets
# --------------------------------------------------------------------------


@torch.no_grad()
def _rect_y_ranges(g, cam, cfg: RenderConfig):
    """Each splat's footprint tile-row range (y0, y1) as host int arrays;
    splats with no footprint get tiles_y + 4 for both (outside every
    band)."""
    tiles_x, tiles_y = cfg.tiles_x(cam.width), cfg.tiles_y(cam.height)
    p = _project_any(g, cam.to(g.device), cfg)
    _, y0, _, y1 = tile_rect(p.mean2d, p.radius, tiles_x, tiles_y, cfg.tile_size)
    on = p.valid & (p.radius > 0)
    out = torch.stack([torch.where(on, y0, tiles_y + 4), torch.where(on, y1, tiles_y + 4)])
    y0, y1 = out.cpu().numpy()
    return y0, y1


def derive_row_cuts(g, cam, cfg: RenderConfig, n_devices: int, m=None,
                    row_weight: float = 0.0) -> list:
    """An equal-CONTENT tile-row partition: cuts [D+1] so every band holds
    about the same per-tile candidate mass (what a band's cost follows
    when its content is bounded by its live rows). For
    make_train_step_equalized and derive_shard_caps(bands=...).
    `row_weight` adds a constant per tile row (in candidate units) to the
    mass; `m` (a measure_occupancy dict) skips measuring."""
    if m is None:
        m = measure_occupancy(g, cam, cfg)
    row_cand = m["cand"].reshape(m["tiles_y"], m["tiles_x"]).sum(1) + float(row_weight)
    cum = np.concatenate([[0], np.cumsum(row_cand)])
    total = cum[-1]
    cuts = [0]
    for d in range(1, n_devices):
        c = int(np.searchsorted(cum, total * d / n_devices))
        cuts.append(min(max(c, cuts[-1] + 1), m["tiles_y"] - (n_devices - d)))
    cuts.append(m["tiles_y"])
    return cuts


def derive_shard_caps(g, cam, cfg: RenderConfig, band_rows: int | None = None,
                      origins=None, bands=None, slack: float = 1.25, m=None) -> RenderConfig:
    """Measure the WORST band and return `cfg` with the tile-sharded
    budgets sized from it at `slack` headroom:

      * shard_prefilter_cap — the most splats whose rect reaches a band
      * shard_slice_cap     — the most home rows in a band's halo range
                              (+ room for the band layout's own copies)
      * pair_cap            — the full image's live pairs scaled by the
                              worst band's candidate share
      * fat_cap / fat_live_cap scaled to the prefilter's share (where set)

    The bands: `bands` = [(ty0, rows), ...] (an equal-content split), or
    a uniform `band_rows` grid at `origins` (default: every band origin a
    contiguous split of that size has). `m` (a measure_occupancy dict)
    skips measuring. gsjax's arithmetic to the integer; repack_rows is
    reset to None as there (inert in the port)."""
    if m is None:
        m = measure_occupancy(g, cam, cfg)
    tiles_y, tiles_x = m["tiles_y"], m["tiles_x"]
    if bands is None:
        if band_rows is None:
            raise ValueError("derive_shard_caps needs either band_rows (uniform grid) "
                             "or bands=[(ty0, rows), ...]")
        if origins is None:
            origins = sorted({min(i * band_rows, tiles_y - band_rows)
                              for i in range(_ceil(tiles_y, band_rows))})
        bands = [(ty0, band_rows) for ty0 in origins]
    y0, y1 = _rect_y_ranges(g, cam, cfg)
    y0s, y1s = np.sort(y0), np.sort(y1)
    n = y0.shape[0]

    pref_cap = 0
    for ty0, rows_b in bands:
        # relevant = (y1 > ty0 - 1) & (y0 < ty0 + rows_b + 1)
        ends_before = np.searchsorted(y1s, ty0 - 1, side="right")
        starts_after = n - np.searchsorted(y0s, ty0 + rows_b + 1, side="left")
        pref_cap = max(pref_cap, n - ends_before - starts_after)
    pref_cap = _round_up(max(int(pref_cap * slack), 4096), 4096)

    # home rows and candidate share of each band, from the full image's
    # layout (a band's own layout has at most these rows)
    seg, cand = m["seg"], m["cand"]
    row_cand = cand.reshape(tiles_y, tiles_x).sum(1)
    slice_cap, worst_share = 0, 0.0
    for ty0, rows_b in bands:
        r0, r1 = max(ty0 - 1, 0), min(ty0 + rows_b + 1, tiles_y)
        slice_cap = max(slice_cap, int(seg[r1 * tiles_x] - seg[r0 * tiles_x]))
        worst_share = max(worst_share,
                          float(row_cand[ty0:ty0 + rows_b].sum()) / max(float(cand.sum()), 1.0))
    # the band's layout appends its own copy rows: room for them
    slice_cap = _round_up(max(int(slice_cap * slack) + 8192, 8192), 4096)
    pair_cap = _round_up(int(m["n_pairs"] * min(worst_share * slack * 1.15, 1.0)) + 65536, 128)

    # the fat budgets scale to the worst band too, or a band's layout
    # runs at the full scene's size whatever the prefilter keeps
    pref_share = min(pref_cap / max(n, 1), 1.0)
    fat_cap = cfg.fat_cap
    if fat_cap is not None:
        fat_cap = min(_round_up(max(int(fat_cap * pref_share * slack), 8192), 8192),
                      (1 << 24) - 8192)
    fat_live_cap = cfg.fat_live_cap
    if fat_live_cap is not None:
        fat_live_cap = _round_up(max(int(fat_live_cap * pref_share * slack), 4096), 4096)
    return dataclasses.replace(cfg, shard_prefilter_cap=pref_cap, shard_slice_cap=slice_cap,
                               pair_cap=pair_cap, fat_cap=fat_cap, fat_live_cap=fat_live_cap,
                               repack_rows=None)
