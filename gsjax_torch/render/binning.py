"""Tile binning over the home layout — the PyTorch counterpart of the
exact-footprint path of gsjax/render/binning.py.

  1. pair expansion: each home row emits up to 9 (tile, pid) candidates,
     one per class offset from its home tile, kept when the tile lies in
     the row's window and band and the splat's ellipse reaches alpha_min
     somewhere in the tile (kernel B, csrc/expand.cu, replacing the TPU
     kernel gsjax/render/binning.py::_expand_kernel);
  2. ONE stable sort by (tile, depth bits, pid), all ascending — the
     reference's global 3-key order. It replaces gsjax/render/repack.py,
     whose per-tile sequences are bit-identical to that global sort;
  3. per-tile segment starts by binary search.

The rect and legacy-home anchors of the padded-list (xla) backend are not
ported yet (ROADMAP queue 1, "reference blend path").
"""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch import kernels
from gsjax_torch.core.camera import Camera
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.render.common import MAX_TILES, box_inside, box_qmin, depth_bits
from gsjax_torch.render.homesort import cull_threshold, sort_perm
from gsjax_torch.render.project import ProjectedSplats

INVALID_TILE = 0x7FFFFFFF  # dead pairs: sorts after every real tile id
_EXPAND_R = 4096  # home-row padding granularity, kept from the reference
EXPAND_COLS = 16  # hx, hy, wx0, wx1, wy0, wy1, validf, mx, my, ca, cb, cc,
#                   thr, -cb/cc, -cb/ca, pad


# --------------------------------------------------------------------------
# kernel B: pair expansion + exact ellipse-tile cull
# --------------------------------------------------------------------------


def expand_pairs_plain(cols, ty0: int, band_rows: int, tiles_x: int, ts: int,
                       span: int):
    """Plain PyTorch version of kernel B (same contract as
    expand_pairs)."""
    k_slots = span * span
    nh_pad = cols.shape[1]
    dev = cols.device
    toi = lambda i: cols[i].to(torch.int32)
    hx, hy, wx0, wx1, wy0, wy1 = (toi(i) for i in range(6))
    okv = cols[6] > 0.5
    mx, my, ca, cb, cc, thr, ncbrcc, ncbrca = (cols[i] for i in range(7, 15))
    ts_f = float(ts)
    lane = torch.arange(nh_pad, dtype=torch.int32, device=dev)
    h = span // 2
    tiles, pids = [], []
    for c in range(k_slots):
        tx = hx + (c % span - h)
        ty = hy + (c // span - h)
        ok = (
            okv
            & (tx >= wx0) & (tx < wx1)
            & (ty >= wy0) & (ty < wy1)
            & (ty >= ty0) & (ty < ty0 + band_rows)
        )
        dxl = tx.to(torch.float32) * ts_f - mx
        dxr = dxl + (ts_f - 1.0)
        dyl = ty.to(torch.float32) * ts_f - my
        dyr = dyl + (ts_f - 1.0)
        inside = box_inside(dxl, dxr, dyl, dyr)
        qmin = box_qmin(ca, cb, cc, ncbrcc, ncbrca, dxl, dxr, dyl, dyr)
        ok = ok & (inside | (qmin <= thr))
        tiles.append(torch.where(ok, (ty - ty0) * tiles_x + tx,
                                 torch.full_like(tx, INVALID_TILE)))
        pids.append(lane * k_slots + c)
    return torch.stack(tiles), torch.stack(pids)


def expand_pairs(cols, ty0: int, band_rows: int, tiles_x: int, ts: int,
                 span: int):
    """cols [16, NH_pad] f32 (rows: hx, hy, wx0, wx1, wy0, wy1, validf, mx,
    my, ca, cb, cc, thr, -cb/cc, -cb/ca, pad; integer rows hold exact f32
    values) → (tile2d [K, NH_pad] i32, pid2d [K, NH_pad] i32), class-major,
    K = span²: the band tile id of class c of each row (INVALID_TILE for a
    dead pair) and pid = row·K + c.

    Kernel B, csrc/expand.cu; replaces the TPU kernel
    gsjax/render/binning.py::_expand_kernel. CPU tensors take the plain
    version; CUDA tensors launch the kernel (there is no fallback)."""
    if cols.device.type == "cpu":
        return expand_pairs_plain(cols, ty0, band_rows, tiles_x, ts, span)
    if cols.device.type != "cuda":
        raise ValueError(f"expand_pairs: unsupported device {cols.device}")
    if cols.dim() != 2 or cols.shape[0] != EXPAND_COLS or cols.dtype != torch.float32:
        raise ValueError("expand_pairs: expected float32 cols [16, NH_pad]")
    cols = cols.contiguous()
    nh_pad = cols.shape[1]
    k_slots = span * span
    if k_slots * nh_pad >= 1 << 31:
        raise ValueError("expand_pairs: pid = row·K + c must fit int32")
    tile2d = torch.empty((k_slots, nh_pad), dtype=torch.int32, device=cols.device)
    pid2d = torch.empty_like(tile2d)
    err = kernels.lib().gsjax_expand_pairs(
        cols.data_ptr(), nh_pad, ty0, band_rows, tiles_x, ts, span,
        tile2d.data_ptr(), pid2d.data_ptr(), kernels.stream_ptr(cols),
    )
    kernels.check(err, "expand_pairs")
    kernels.LAUNCHES["expand"] += 1
    return tile2d, pid2d


def expand_cols(p: ProjectedSplats, layout, cfg: RenderConfig):
    """The expansion kernel's input columns [16, NH_pad] (NH padded to a
    multiple of 4096 with dead rows, as in the reference)."""
    n = p.depth.shape[0]
    nh_pad = -(-n // _EXPAND_R) * _EXPAND_R
    ca, cb, cc = p.conic[:, 0], p.conic[:, 1], p.conic[:, 2]
    f = lambda v: v.to(torch.float32)
    cols = torch.stack(
        [
            f(layout.home_x), f(layout.home_y),
            f(layout.win[:, 0]), f(layout.win[:, 1]),
            f(layout.win[:, 2]), f(layout.win[:, 3]),
            f(p.valid),
            p.mean2d[:, 0], p.mean2d[:, 1], ca, cb, cc,
            cull_threshold(p.opacity, cfg.alpha_min),
            # per-row reciprocals, as in the reference (a per-pair divide
            # would round the same but cost 9x)
            -cb / cc, -cb / ca,
            torch.zeros_like(ca),
        ]
    ).detach()
    return torch.nn.functional.pad(cols, (0, nh_pad - n))


def expand_home_pairs(p: ProjectedSplats, layout, ty0: int, band_rows: int,
                      tiles_x: int, cfg: RenderConfig):
    """Exact-mode pair expansion over the home layout. Returns (tile2d
    [K, nh_pad] i32, pid2d [K, nh_pad] i32, dbits [nh_pad] i32 depth
    bits, nh_pad), class-major as in the reference."""
    cols = expand_cols(p, layout, cfg)
    nh_pad = cols.shape[1]
    tile2d, pid2d = expand_pairs(cols, ty0, band_rows, tiles_x,
                                 cfg.tile_size, cfg.tile_span)
    dbits = torch.nn.functional.pad(depth_bits(p.depth.detach()),
                                    (0, nh_pad - p.depth.shape[0]))
    return tile2d, pid2d, dbits, nh_pad


@dataclasses.dataclass(frozen=True)
class TileBins:
    """pid_sorted [S] int32 pair ids (pid = home row·K + class, so sid =
    pid // tile_span²), tile-major then near-to-far — only the live pairs
    (S = n_pairs); tile_starts [T+1] int32 offsets into pid_sorted;
    n_clamped, n_pairs, n_repack_overflow: diagnostics; ty0: first tile
    row of the band."""

    pid_sorted: torch.Tensor
    tile_starts: torch.Tensor
    n_clamped: torch.Tensor
    n_pairs: torch.Tensor
    ty0: int
    n_repack_overflow: torch.Tensor
    tiles_x: int
    band_rows: int


def sort_pairs(tile2d, dbits):
    """Live pairs of the class-major expansion, sorted by (tile, depth
    bits, pid): (pid_sorted [S] i32, tile_sorted [S] i32).

    The candidates are flattened row-major ([NH, K], i.e. in ascending
    pid) BEFORE compaction and the stable sort, so equal (tile, depth)
    keys keep ascending pid — tile2d.reshape(-1) would be class-major and
    break the tie order."""
    k_slots = tile2d.shape[0]
    tile_flat = tile2d.T.reshape(-1)  # index = pid
    live = torch.nonzero(tile_flat != INVALID_TILE).squeeze(1)
    tile_live = tile_flat[live]
    order = sort_perm(tile_live, dbits[live // k_slots])
    return live[order].to(torch.int32), tile_live[order]


def build_tile_bins(p: ProjectedSplats, cam: Camera, cfg: RenderConfig,
                    ty0: int = 0, band_rows: int | None = None,
                    anchor: str = "home", layout=None) -> TileBins:
    """Bin the home rows `p` of `layout` into tile rows
    [ty0, ty0 + band_rows) (the whole image by default)."""
    if anchor != "home" or layout is None or cfg.footprint_clamp:
        raise NotImplementedError(
            "only anchor='home' with an exact-footprint layout is ported; "
            "the rect and legacy anchors wait for ROADMAP queue 1 "
            "'reference blend path'"
        )
    span = cfg.tile_span
    if span % 2 != 1:
        raise ValueError("anchor='home' requires an odd tile_span")
    tiles_x = cfg.tiles_x(cam.width)
    if band_rows is None:
        band_rows = cfg.tiles_y(cam.height)
    n_tiles = tiles_x * band_rows
    if n_tiles > MAX_TILES:
        raise ValueError(f"{n_tiles} tiles exceeds {MAX_TILES}; increase tile_size")
    tile2d, _pid2d, dbits, _ = expand_home_pairs(p, layout, ty0, band_rows,
                                                 tiles_x, cfg)
    pid_sorted, tile_of = sort_pairs(tile2d, dbits)
    tile_starts = torch.searchsorted(
        tile_of,
        torch.arange(n_tiles + 1, dtype=torch.int32, device=tile_of.device),
        side="left",
    ).to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=tile_of.device)
    return TileBins(
        pid_sorted=pid_sorted,
        tile_starts=tile_starts,
        n_clamped=zero,  # budgets live in the layout
        n_pairs=torch.tensor(pid_sorted.shape[0], dtype=torch.int32,
                             device=tile_of.device),
        ty0=ty0,
        n_repack_overflow=zero,  # one stable sort: no repack grid
        tiles_x=tiles_x,
        band_rows=band_rows,
    )
