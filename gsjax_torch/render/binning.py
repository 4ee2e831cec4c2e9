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

The legacy span-budget mode (footprint_clamp=True) and the rect anchor
enumerate each splat's span-clamped rect densely instead, [N, K] in plain
PyTorch on every device (the reference computes them in jnp, not in a
kernel), with the same cull and the same sort.
"""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch import kernels, trace
from gsjax_torch.core.camera import Camera
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.render.common import (MAX_TILES, box_inside, box_qmin, clamp_rect_to_span,
                                       depth_bits, tile_rect)
from gsjax_torch.render.homesort import (band_prefilter, band_prefilter_cap, band_slice_cap,
                                         build_home_layout, cull_threshold, slice_band_rows,
                                         sort_key)
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
    trace.host_sync(count)
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
    """pid_sorted [S] int32 pair ids (pid = row·K + slot, so sid = pid //
    tile_span²), tile-major then near-to-far — only the live pairs (S =
    n_pairs); tile_starts [T+1] int32 offsets into pid_sorted;
    tile_counts [T] int32; n_clamped, n_pairs, n_repack_overflow:
    diagnostics; ty0: first tile row of the band."""

    pid_sorted: torch.Tensor
    tile_starts: torch.Tensor
    tile_counts: torch.Tensor
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


def span_clamped_pairs(p: ProjectedSplats, cfg: RenderConfig, anchor: str,
                       ty0: int, band_rows: int, tiles_x: int, tiles_y: int):
    """The span-budget enumeration of the rect and legacy-home anchors
    (gsjax/render/binning.py::build_tile_bins' else branch), dense over
    [N, K] in plain PyTorch: each splat's radius rect clamped to the
    span (centred on the mean's tile under footprint_clamp or the home
    anchor), slot k = (k % span, k // span) of a span×span grid anchored
    at the clamped rect's corner ("rect") or at home − span//2 ("home",
    home = the mean's tile clipped to the image, as
    homesort._legacy_home), kept when it lies in the rect and the band
    and the ellipse reaches α_min in the tile (kernel B's cull: box_qmin
    against homesort.cull_threshold). Returns the live pairs in ascending
    pid = i·K + k, (pid_live [S] i32, key [S] i64 = sort_key(band tile,
    depth bits)), and n_clamped (the valid splats the clamp cut)."""
    span = cfg.tile_span
    k_slots = span * span
    ts = cfg.tile_size
    mean2d, radius = p.mean2d.detach(), p.radius.detach()
    x0, y0, x1, y1 = tile_rect(mean2d, radius, tiles_x, tiles_y, ts)
    x0, y0, x1, y1, clamped = clamp_rect_to_span(
        x0, y0, x1, y1, mean2d, ts, span,
        center_window=cfg.footprint_clamp or anchor == "home",
    )
    n_clamped = (clamped & p.valid).sum().to(torch.int32)
    slot = torch.arange(k_slots, dtype=torch.int32, device=mean2d.device)
    sx, sy = (slot % span)[None, :], (slot // span)[None, :]
    if anchor == "home":
        home = lambda v, hi: torch.clamp(torch.floor(v / ts).to(torch.int32), 0, hi - 1)
        txs = (home(mean2d[:, 0], tiles_x) - span // 2)[:, None] + sx  # [N, K]
        tys = (home(mean2d[:, 1], tiles_y) - span // 2)[:, None] + sy
    elif anchor == "rect":
        txs = x0[:, None] + sx
        tys = y0[:, None] + sy
    else:
        raise ValueError(f"unknown anchor {anchor!r}")
    ok = (
        p.valid[:, None]
        & (txs >= x0[:, None]) & (txs < x1[:, None])
        & (tys >= y0[:, None]) & (tys < y1[:, None])
        & (tys >= ty0) & (tys < ty0 + band_rows)
    )
    conic = p.conic.detach()
    ca, cb, cc = conic[:, 0:1], conic[:, 1:2], conic[:, 2:3]
    ts_f = float(ts)
    dxl = txs.to(torch.float32) * ts_f - mean2d[:, 0:1]
    dxr = dxl + (ts_f - 1.0)
    dyl = tys.to(torch.float32) * ts_f - mean2d[:, 1:2]
    dyr = dyl + (ts_f - 1.0)
    thr = cull_threshold(p.opacity.detach(), cfg.alpha_min)[:, None]
    qmin = box_qmin(ca, cb, cc, -cb / cc, -cb / ca, dxl, dxr, dyl, dyr)
    ok = ok & (box_inside(dxl, dxr, dyl, dyr) | (qmin <= thr))
    live = torch.nonzero(ok.reshape(-1)).squeeze(1)  # ascending pid
    tile = ((tys - ty0) * tiles_x + txs).reshape(-1)[live]
    dbits = depth_bits(p.depth.detach())[live // k_slots]
    return live.to(torch.int32), sort_key(tile, dbits), n_clamped


@trace.spanned("bins")
def build_tile_bins(p: ProjectedSplats, cam: Camera, cfg: RenderConfig,
                    ty0: int = 0, band_rows: int | None = None,
                    anchor: str = "rect", layout=None,
                    rows_live: int | None = None) -> TileBins:
    """Bin `p` into tile rows [ty0, ty0 + band_rows) (the whole image by
    default). `rows_live` (the home anchor only; default band_rows)
    bounds kernel B's band check to [ty0, ty0 + rows_live), a band's
    owned rows under an equal-content split, while the bins keep
    tiles_x·band_rows tiles (those past rows_live stay empty).

    With anchor="home" and an exact-footprint `layout`
    (homesort.build_home_layout, footprint_clamp=False), `p` are the
    layout's home rows and kernel B expands each into its classes: the
    merged stream equals an unclamped rect enumeration. Otherwise (the
    legacy span-budget mode, or the rect anchor) each row's span-clamped
    rect is enumerated densely (span_clamped_pairs); both anchors give
    the same (tile, depth) pair set, and the home anchor's slot k is the
    pair's class, as the stream blend's backward needs."""
    tiles_x = cfg.tiles_x(cam.width)
    tiles_y = cfg.tiles_y(cam.height)
    if band_rows is None:
        band_rows = tiles_y
    n_tiles = tiles_x * band_rows
    if n_tiles > MAX_TILES:
        raise ValueError(f"{n_tiles} tiles exceeds {MAX_TILES}; increase tile_size")
    dev = p.depth.device
    if anchor == "home" and layout is not None and not cfg.footprint_clamp:
        if cfg.tile_span % 2 != 1:
            raise ValueError("anchor='home' requires an odd tile_span")
        pid_live, key = expand_live_pairs(p, layout, ty0,
                                          band_rows if rows_live is None else rows_live,
                                          tiles_x, cfg)
        n_clamped = torch.zeros((), dtype=torch.int32, device=dev)  # budgets live in the layout
    else:
        pid_live, key, n_clamped = span_clamped_pairs(p, cfg, anchor, ty0, band_rows,
                                                      tiles_x, tiles_y)
    pid_sorted, tile_of = sort_pairs(pid_live, key)
    tile_starts = torch.searchsorted(
        tile_of,
        torch.arange(n_tiles + 1, dtype=torch.int32, device=dev),
        side="left",
    ).to(torch.int32)
    return TileBins(
        pid_sorted=pid_sorted,
        tile_starts=tile_starts,
        tile_counts=tile_starts[1:] - tile_starts[:-1],
        n_clamped=n_clamped,
        n_pairs=torch.full((), pid_sorted.shape[0], dtype=torch.int32, device=dev),
        ty0=ty0,
        n_repack_overflow=torch.zeros((), dtype=torch.int32, device=dev),  # one stable sort
        tiles_x=tiles_x,
        band_rows=band_rows,
    )


def build_band_bins(p: ProjectedSplats, cam: Camera, cfg: RenderConfig, ty0: int, band: int,
                    rows_live: int | None = None, restrict: bool | None = None,
                    return_extras: bool = False, on_stage=None):
    """A band's stream chain from projected splats to its pairs, the one
    copy of the band's cap rules (parallel.render_sharded._render_band,
    lazy.build_band_plan): band_prefilter to cap_n splats (cfg's
    shard_prefilter_cap, else band_prefilter_cap at band_prefilter_slack,
    at most N rounded up to 4096), the home layout (kernel A),
    slice_band_rows to cap home rows (shard_slice_cap, else
    band_slice_cap at band_slice_slack), and build_tile_bins (kernel B)
    with its band check on [ty0, ty0 + rows_live). `restrict` (default:
    the band is narrower than the image) runs the prefilter and the
    slice; without them the layout is the whole image's.

    Returns (p_home, layout, bins, n_pref, n_sliced), the prefilter's
    and the slice's drops; with return_extras (restrict must hold) also
    build_home_layout's extras with "gidx" (each prefiltered row's
    splat), "src_band" (src_sorted's window) and "start" (the window's
    first home row). on_stage(name, out), when given, is called after
    each stage with what it made: "prefilter" and "home_layout" and
    "slice" with their splats, "bins_sort" with the bins."""
    tiles_y, tiles_x = cfg.tiles_y(cam.height), cfg.tiles_x(cam.width)
    if rows_live is None:
        rows_live = band
    if restrict is None:
        restrict = band < tiles_y
    if return_extras and not restrict:
        raise ValueError("return_extras needs the prefilter and the slice (restrict=True)")
    lap = on_stage or (lambda name, out: None)
    n_pref = n_sliced = 0
    if restrict:
        n = p.depth.shape[0]
        cap_n = cfg.shard_prefilter_cap or band_prefilter_cap(n, tiles_y, band,
                                                              cfg.band_prefilter_slack)
        cap_n = min(cap_n, -(-n // 4096) * 4096)
        p, n_pref, *gidx = band_prefilter(p, ty0, rows_live, tiles_y, tiles_x, cap_n, cfg,
                                          return_idx=return_extras)
        lap("prefilter", p)
    p, layout, *extras = build_home_layout(p, cam, cfg, return_extras=return_extras)
    lap("home_layout", p)
    if restrict:
        cap = cfg.shard_slice_cap or band_slice_cap(layout.perm.shape[0], tiles_y, band,
                                                    cfg.band_slice_slack)
        rows = (extras[0]["src_sorted"],) if return_extras else ()
        p, layout, n_sliced, *window = slice_band_rows(p, layout, ty0, band, cap, rows_live,
                                                       extra_rows=rows)
        lap("slice", p)
    bins = build_tile_bins(p, cam, cfg, ty0=ty0, band_rows=band, anchor="home", layout=layout,
                           rows_live=rows_live)
    lap("bins_sort", bins)
    if not return_extras:
        return p, layout, bins, n_pref, n_sliced
    (src_band,), start = window
    return p, layout, bins, n_pref, n_sliced, dict(extras[0], gidx=gidx[0], src_band=src_band,
                                                   start=start)
