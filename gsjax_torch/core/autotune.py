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
step. derive_row_cuts and derive_shard_caps wait for the multi-device
port.
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
