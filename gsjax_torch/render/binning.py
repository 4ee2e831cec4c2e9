"""Tile binning over the home layout — the PyTorch counterpart of the
exact-footprint path of gsjax/render/binning.py.

  1. pair expansion: each home row emits up to 9 (tile, pid) candidates,
     one per class offset from its home tile, kept when the tile lies in
     the row's window and band and the splat's ellipse reaches alpha_min
     somewhere in the tile; only the live ones come out, in pid order,
     with their sort keys (kernel B, csrc/expand.cu, replacing the TPU
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
from gsjax_torch.render.homesort import cull_threshold, sort_key
from gsjax_torch.render.project import ProjectedSplats

INVALID_TILE = 0x7FFFFFFF  # dead pairs: sorts after every real tile id
_EXPAND_R = 4096  # home-row padding granularity, kept from the reference
# kernel B's tile spans → its home rows a block (csrc/expand.cu's launch
# table): a block stages rows · span² · 12 bytes in shared memory
EXPAND_ROWS = {1: 256, 3: 256, 5: 256, 7: 256, 9: 128, 11: 128, 13: 64, 15: 64}


# --------------------------------------------------------------------------
# kernel B: pair expansion + exact ellipse-tile cull
# --------------------------------------------------------------------------


def expand_pairs_plain(cols, ty0: int, band_rows: int, tiles_x: int, ts: int,
                       span: int):
    """The dense expansion in plain PyTorch, which kernel B's plain version
    compacts: cols [16, NH_pad] f32 (rows: hx, hy, wx0, wx1, wy0, wy1,
    validf, mx, my, ca, cb, cc, thr, -cb/cc, -cb/ca, pad; integer rows hold
    exact f32 values) → (tile2d [K, NH_pad] i32, pid2d [K, NH_pad] i32),
    class-major, K = span²: the band tile id of class c of each row
    (INVALID_TILE for a dead pair) and pid = row·K + c."""
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


def expand_cols(p: ProjectedSplats, layout, cfg: RenderConfig):
    """The dense plain version's input columns [16, NH_pad] (NH padded to
    a multiple of 4096 with dead rows, as in the reference)."""
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


def compact_pairs_plain(tile2d, dbits):
    """The live candidates of a dense class-major expansion (tile2d [K,
    NH_pad], dbits [NH_pad]) in ascending pid: (pid_live [S] i32, key [S]
    i64 = homesort.sort_key(tile, dbits)).

    The candidates are flattened row-major ([NH, K], i.e. in ascending
    pid) BEFORE compaction, so the stable sort keeps equal (tile, depth)
    keys in ascending pid — tile2d.reshape(-1) would be class-major and
    break the tie order."""
    k_slots = tile2d.shape[0]
    tile_flat = tile2d.T.reshape(-1)  # index = pid
    live = torch.nonzero(tile_flat != INVALID_TILE).squeeze(1)
    return live.to(torch.int32), sort_key(tile_flat[live], dbits[live // k_slots])


def expand_live_pairs_plain(p: ProjectedSplats, layout, ty0: int, band_rows: int,
                            tiles_x: int, cfg: RenderConfig):
    """Plain PyTorch version of kernel B (same contract as
    expand_live_pairs): the dense expansion, then its compaction."""
    cols = expand_cols(p, layout, cfg)
    tile2d, _ = expand_pairs_plain(cols, ty0, band_rows, tiles_x, cfg.tile_size,
                                   cfg.tile_span)
    dbits = torch.nn.functional.pad(depth_bits(p.depth.detach()),
                                    (0, cols.shape[1] - p.depth.shape[0]))
    return compact_pairs_plain(tile2d, dbits)


def expand_live_pairs(p: ProjectedSplats, layout, ty0: int, band_rows: int,
                      tiles_x: int, cfg: RenderConfig):
    """Exact-mode pair expansion over the home layout: class c of home
    row i is the tile (home_x + c % span − span//2, home_y + c // span −
    span//2), kept when it lies in the row's window and in the band
    [ty0, ty0 + band_rows) and the splat's α_min ellipse reaches it.
    Returns only the live candidates, in ascending pid = i·K + c (K =
    span²): (pid_live [S] i32, key [S] i64 = (band tile id << 32) | (depth
    bits + 2^31), homesort.sort_key's packing). One device-to-host read,
    of S.

    Kernel B, csrc/expand.cu; replaces the TPU kernel
    gsjax/render/binning.py::_expand_kernel. CPU tensors take the plain
    version (any odd span); CUDA tensors launch the kernel (there is no
    fallback), which is built for the spans of EXPAND_ROWS (odd, 1 to
    15) and raises for any other."""
    if p.depth.device.type == "cpu":
        return expand_live_pairs_plain(p, layout, ty0, band_rows, tiles_x, cfg)
    if p.depth.device.type != "cuda":
        raise ValueError(f"expand_live_pairs: unsupported device {p.depth.device}")
    pid_live, key, count = launch_expand(*expand_inputs(p, layout, cfg), ty0, band_rows,
                                         tiles_x, cfg.tile_size, cfg.tile_span)
    s = int(count)  # the one device-to-host read
    return pid_live[:s], key[:s]


def expand_inputs(p: ProjectedSplats, layout, cfg: RenderConfig):
    """Kernel B's inputs, the home rows' own tensors in place where their
    types and layouts allow: (home_x, home_y [NH] i32, win [NH, 4] i32,
    valid [NH] bool, mean2d [NH, 2], conic [NH, 3] f32 with unit column
    stride, thr [NH] f32 = cull_threshold, dbits [NH] i32 depth bits, a
    view of the depths: its row stride is the depths')."""
    i32 = lambda v: v.to(torch.int32).contiguous()
    mean2d, conic = p.mean2d.detach(), p.conic.detach()
    if mean2d.stride(1) != 1 or conic.stride(1) != 1:
        mean2d, conic = mean2d.contiguous(), conic.contiguous()
    return (i32(layout.home_x), i32(layout.home_y), i32(layout.win),
            p.valid.to(torch.bool).contiguous(), mean2d, conic,
            cull_threshold(p.opacity.detach(), cfg.alpha_min).contiguous(),
            p.depth.detach().to(torch.float32).view(torch.int32))


def launch_expand(home_x, home_y, win, valid, mean2d, conic, thr, dbits, ty0: int,
                  band_rows: int, tiles_x: int, ts: int, span: int):
    """Launch kernel B on expand_inputs' tensors without waiting for it:
    (pid_live [K·NH] i32, key [K·NH] i64, count 0-d i32 on the card); the
    first `count` entries of each are the live pairs."""
    dev, nh, k_slots = home_x.device, home_x.shape[0], span * span
    if span not in EXPAND_ROWS:
        raise ValueError(f"expand_live_pairs: tile_span {span} on the card must be one of "
                         f"{tuple(EXPAND_ROWS)}")
    if k_slots * nh >= 1 << 31:
        raise ValueError("expand_live_pairs: pid = row·K + c must fit int32")
    if (win.shape != (nh, 4) or mean2d.shape != (nh, 2) or conic.shape != (nh, 3)
            or mean2d.dtype != torch.float32 or conic.dtype != torch.float32):
        raise ValueError("expand_live_pairs: expected win [NH, 4] i32, mean2d [NH, 2] "
                         "and conic [NH, 3] f32")
    blocks = -(-nh // EXPAND_ROWS[span])
    # the blocks' status words, then the ticket counter and the live count
    scratch = torch.empty(blocks + 1, dtype=torch.int64, device=dev)
    pid_live = torch.empty(k_slots * nh, dtype=torch.int32, device=dev)
    key = torch.empty(k_slots * nh, dtype=torch.int64, device=dev)
    err = kernels.lib().gsjax_expand_live_pairs(
        home_x.data_ptr(), home_y.data_ptr(), win.data_ptr(), valid.data_ptr(),
        mean2d.data_ptr(), mean2d.stride(0), conic.data_ptr(), conic.stride(0),
        thr.data_ptr(), dbits.data_ptr(), dbits.stride(0), nh, ty0, band_rows, tiles_x,
        ts, span, scratch.data_ptr(), pid_live.data_ptr(), key.data_ptr(),
        kernels.stream_ptr(home_x),
    )
    kernels.check(err, "expand_live_pairs")
    kernels.LAUNCHES["expand"] += 1
    return pid_live, key, scratch.view(torch.int32)[-1]


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


def sort_pairs(pid_live, key):
    """The live pairs (in ascending pid) sorted by (tile, depth bits,
    pid): (pid_sorted [S] i32, tile_sorted [S] i32). The sort is stable,
    so equal (tile, depth) keys keep ascending pid."""
    key_sorted, order = torch.sort(key, stable=True)
    return pid_live[order], (key_sorted >> 32).to(torch.int32)


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
    pid_sorted, tile_of = sort_pairs(*expand_live_pairs(p, layout, ty0, band_rows,
                                                        tiles_x, cfg))
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
        n_pairs=torch.full((), pid_sorted.shape[0], dtype=torch.int32,
                           device=tile_of.device),
        ty0=ty0,
        n_repack_overflow=zero,  # one stable sort: no repack grid
        tiles_x=tiles_x,
        band_rows=band_rows,
    )
