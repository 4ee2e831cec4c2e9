"""Stream backend tile blend — the PyTorch counterpart of
gsjax/render/pallas_stream.py, forward and backward.

Splats are laid out once per frame in (home tile, depth) order
(render/homesort.py) and the pairs sorted by (tile, depth, pid)
(render/binning.py). The blend walks each tile's segment of the sorted
pair stream front to back in chunks of cfg.chunk pairs:

  α = min(alpha_clamp, op·fexp(power)); eligible iff α ≥ alpha_min and
  power ≤ 0; the virtual transmittance C multiplies every eligible pair's
  (1 − α) — termination is sticky at transmittance_eps — while the actual
  T_act tracks included pairs only; a tile exits at a chunk boundary once
  every pixel's C < eps.

The backward is the reference's hand-derived VJP (pallas_flat.py's module
docstring),

  dL/dα_i = v_i·T_i − (U_i + ct_T·T_act)/(1−α_i),  v_i = rgb_i·ct_img,
  U_i = Σ_{j>i} v_j·w_j,

chained to mean2d, conic, rgb and opacity per pair. It replays the
forward's n_done chunks in the forward's order from C = 1 with the
forward's expressions, so its include decisions are the forward's, and
takes U_i from the forward's image: U_i = ct_img·(img − Σ_{j≤i} w_j·rgb_j).
(The reference replays in reverse from the exit state and rebuilds C at a
chunk's entry by division, which may flip one splat per pixel near T ≈
eps.)

Kernel C (`stream_forward`, csrc/stream_fwd.cu) replaces the TPU kernel
gsjax/render/pallas_stream.py::_stream_fwd_kernel, kernel D
(`stream_backward`, csrc/stream_bwd.cu) its _stream_bwd_kernel. The TPU's
band DMA, pid windows, bf16 split table, slot grouping and read-modify-
write gradient bands are TPU plumbing and have no counterpart: the CUDA
kernels read exact f32 attributes by home row, and D writes one gradient
row per pair id. The tile loops, in CUDA (csrc/blend.cuh) and in their
plain versions here (blend_forward_plain, blend_backward_plain), are the
flat backend's too (render/flat.py): only the row source differs.
"""

from __future__ import annotations

import torch

from gsjax_torch import kernels, trace
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.render.common import box_inside, box_qmin, gaussian_power
from gsjax_torch.render.composite import assemble_band, att_table, clipped_pair_stream
from gsjax_torch.render.fastmath import fexp
from gsjax_torch.render.homesort import cull_threshold

FWD_ROWS = 8  # img(3), T_act, C, n_done, spare(2)
_PLAIN_TILE_BATCH = 256  # tiles per batch of the plain blend
# the backward kernel's grouping (csrc/blend.cuh: kBwdPairs, kBwdPixels):
# pairs reduced together over a warp's pixels, pixels per thread
BWD_PAIRS, BWD_PIXELS = 4, 2
# the forward kernel's grouping (csrc/blend.cuh: kFwdPixels, kFwdWarpW):
# pixels per thread, and the width of each warp's rectangle of the tile
# (32·FWD_PIXELS / FWD_WARP_W rows high); and its strip cull's constants
# (kCullDegenerate, kCullWiden)
FWD_PIXELS, FWD_WARP_W = 2, 8
CULL_DEGENERATE, CULL_WIDEN = 2.0 ** -6, 1.0 + 2.0 ** -9


def pair_rows(att, pid, starts, cfg: RenderConfig):
    """The stream backend's chunk rows for the plain blends: rows(t, k,
    valid) → (a [b, chunk, 9], key [b, chunk]) for chunk k of tiles t [b]
    with lane mask valid [b, chunk] — the attributes of the pairs at
    stream positions starts[t] + k·chunk + lane (home row pid // K, zero
    on masked lanes) and their pair ids, the rows their gradients land
    in."""
    k_slots = cfg.tile_span * cfg.tile_span
    lane = torch.arange(cfg.chunk, device=att.device)

    def rows(t, k, valid):
        pos = starts[t].to(torch.int64)[:, None] + k * cfg.chunk + lane
        key = pid[torch.where(valid, pos, 0)].to(torch.int64)
        return torch.where(valid[..., None], att[key // k_slots], 0.0), key

    return rows


def blend_forward_plain(rows, starts, ty0: int, tiles_x: int, cfg: RenderConfig):
    """The plain front-to-back blend of kernels C and E (their contract),
    chunk rows from `rows` (pair_rows, flat.slot_rows). Tiles go in
    batches of similar pair counts (sorted by count, so a batch pads only
    to its own densest tile), one chunk at a time with a cumprod down the
    chunk; tiles that terminated or ran out of pairs leave the batch. No
    tile's list is truncated."""
    dev = starts.device
    ts, chunk = cfg.tile_size, cfg.chunk
    n_px = ts * ts
    n_tiles = starts.shape[0] - 1
    out = torch.zeros((n_tiles, FWD_ROWS, n_px), dtype=torch.float32, device=dev)
    out[:, 3:5] = 1.0  # a tile with no pairs: T_act = C = 1
    counts = (starts[1:] - starts[:-1]).to(torch.int64)
    order = torch.argsort(counts, descending=True, stable=True)
    counts_sorted = counts[order].cpu()
    n_busy = int((counts_sorted > 0).sum())
    pix = torch.arange(n_px, device=dev)
    pxl, pyl = (pix % ts).to(torch.float32), (pix // ts).to(torch.float32)
    lane = torch.arange(chunk, device=dev)
    eps = cfg.transmittance_eps

    for b0 in range(0, n_busy, _PLAIN_TILE_BATCH):
        tb = order[b0:b0 + _PLAIN_TILE_BATCH]
        nb = tb.shape[0]
        cnt = counts[tb]
        px = ((tb % tiles_x) * ts).to(torch.float32)[:, None] + pxl
        py = ((tb // tiles_x + ty0) * ts).to(torch.float32)[:, None] + pyl
        C = torch.ones((nb, n_px), dtype=torch.float32, device=dev)
        T_act = torch.ones_like(C)
        img = torch.zeros((nb, n_px, 3), dtype=torch.float32, device=dev)
        n_done = torch.zeros(nb, dtype=torch.float32, device=dev)
        active = torch.arange(nb, device=dev)
        for k in range(-(-int(counts_sorted[b0]) // chunk)):
            active = active[k * chunk < cnt[active]]
            if active.numel() == 0:
                break
            pos = k * chunk + lane  # [chunk]
            valid = pos[None, :] < cnt[active, None]  # [b, chunk]
            a, _ = rows(tb[active], k, valid)  # [b, chunk, 9]
            dx = px[active][:, :, None] - a[:, None, :, 0]  # [b, n_px, chunk]
            dy = py[active][:, :, None] - a[:, None, :, 1]
            power = gaussian_power(a[:, None, :, 2:5], dx, dy)
            alpha = torch.clamp(a[:, None, :, 8] * fexp(power), max=cfg.alpha_clamp)
            eligible = valid[:, None, :] & (alpha >= cfg.alpha_min) & (power <= 0.0)
            f = torch.where(eligible, 1.0 - alpha, 1.0)
            incl = torch.cumprod(f, dim=-1)
            excl = torch.cat([torch.ones_like(incl[..., :1]), incl[..., :-1]], dim=-1)
            C0 = C[active][:, :, None]
            Cc = C0 * incl
            include = eligible & (Cc >= eps)
            w = torch.where(include, C0 * excl * alpha, 0.0)
            img[active] += torch.einsum("bpc,bcr->bpr", w, a[:, :, 5:8])
            t_min = torch.where(include, Cc, 2.0).amin(dim=-1)
            T_act[active] = torch.where(t_min > 1.5, T_act[active], t_min)
            C[active] = Cc[..., -1]
            n_done[active] = float(k + 1)
            active = active[C[active].amax(dim=-1) >= eps]
        out[tb, 0:3] = img.transpose(1, 2)
        out[tb, 3] = T_act
        out[tb, 4] = C
        out[tb, 5] = n_done[:, None]
    return out


def fwd_warp_of_pixel(ts: int, device=None):
    """The forward kernel's warp of each pixel of a tile [ts²] (row-major
    pixel index): warp w owns the FWD_WARP_W-wide rectangle at column
    (w % (ts / FWD_WARP_W)), row (w // (ts / FWD_WARP_W)) of rectangles."""
    hw = 32 * FWD_PIXELS // FWD_WARP_W
    pix = torch.arange(ts * ts, device=device)
    return (pix // ts // hw) * (ts // FWD_WARP_W) + pix % ts // FWD_WARP_W


def strip_cull_plain(a, x0, y0, cfg: RenderConfig):
    """Kernels C's and E's strip cull (csrc/blend.cuh: cull_prep,
    strip_reaches), op for op but for the device logf: whether each pair
    of a [b, m, 9] (a chunk's rows) can be eligible at some pixel of each
    forward warp's rectangle of its tile, whose top-left pixel is (x0, y0)
    [b] f32. Returns [b, m, n_warps] bool. Conservative: a pair is dropped
    only where its α_min ellipse — the conic quadratic's exact minimum over
    the rectangle against cull_threshold widened by CULL_WIDEN — misses
    the rectangle; with op < α_min it reaches no pixel; a conic that is not
    positive definite, or near-degenerate (det ≤ CULL_DEGENERATE·a·c),
    reaches every warp."""
    mx, my, ca, cb, cc, op = (a[..., c, None] for c in (0, 1, 2, 3, 4, 8))
    thr = cull_threshold(op, cfg.alpha_min) * CULL_WIDEN
    proper = (ca > 0) & (cc > 0) & (ca * cc - cb * cb > CULL_DEGENERATE * (ca * cc))
    ts = cfg.tile_size
    hw = 32 * FWD_PIXELS // FWD_WARP_W
    w = torch.arange(ts * ts // (32 * FWD_PIXELS), device=a.device)
    xl = (x0[:, None] + ((w % (ts // FWD_WARP_W)) * FWD_WARP_W).to(torch.float32))[:, None]
    yl = (y0[:, None] + ((w // (ts // FWD_WARP_W)) * hw).to(torch.float32))[:, None]
    dxl, dxr = xl - mx, (xl + float(FWD_WARP_W - 1)) - mx  # [b, m, n_warps]
    dyl, dyr = yl - my, (yl + float(hw - 1)) - my
    qmin = box_qmin(ca, cb, cc, -cb / cc, -cb / ca, dxl, dxr, dyl, dyr)
    reach = box_inside(dxl, dxr, dyl, dyr) | ~(qmin > thr) | ~proper
    return reach & ~(op < cfg.alpha_min)


def check_kernel_args(name: str, cfg: RenderConfig, att, shapes_ok: bool,
                      n_tiles: int, indices, cotangents=None) -> None:
    """Raise ValueError on what the blend kernels (C-F) do not take: a
    device other than CUDA, attributes that are not float32 with 9
    columns, inputs that fail the caller's shape tests (shapes_ok), index
    arrays that are not int32, a tile or chunk too large for a block; in
    the backward (cotangents = (fwd_out, ct_img, ct_T)), cotangents of
    another shape or type."""
    if att.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {att.device}")
    if att.dtype != torch.float32 or att.shape[-1] != 9 or not shapes_ok:
        raise ValueError(f"{name}: unexpected input shapes or types: attributes "
                         f"{tuple(att.shape)} {att.dtype}")
    if any(x.dtype != torch.int32 for x in indices):
        raise ValueError(f"{name}: index arrays must be int32")
    ts = cfg.tile_size
    n_px = ts * ts
    if cotangents is None:
        warp_px = 32 * FWD_PIXELS
        n_warps = n_px // warp_px
        if (n_px % warp_px or ts % FWD_WARP_W or ts % (warp_px // FWD_WARP_W)
                or n_warps & (n_warps - 1) or n_px > 1024 or cfg.chunk * 13 * 4 > 48 * 1024):
            raise ValueError(f"{name}: tile_size 8, 16 or 32 and chunk ≤ 945 supported "
                             "(a power of two of warp rectangles of "
                             f"{FWD_WARP_W}×{warp_px // FWD_WARP_W} pixels)")
        return
    shapes = {"fwd_out": (n_tiles, FWD_ROWS, n_px), "ct_img": (n_tiles, n_px, 3),
              "ct_T": (n_tiles, n_px)}
    for (what, shape), x in zip(shapes.items(), cotangents):
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 {what} {shape}")
    warp_px = 32 * BWD_PIXELS
    n_warps = n_px // warp_px
    smem = 4 * (cfg.chunk * (9 + n_warps * 9 + 1) + n_warps)  # blend_bwd_smem
    if n_px % warp_px or n_px > 1024 or smem > 227 * 1024:
        raise ValueError(f"{name}: tile_size² must be a multiple of {warp_px} up "
                         "to 1024, and the chunk's partial sums fit 227 KB")


def stream_forward_plain(att, pid, starts, ty0: int, tiles_x: int,
                         cfg: RenderConfig):
    """Plain PyTorch version of kernel C (same contract as
    stream_forward)."""
    return blend_forward_plain(pair_rows(att, pid, starts, cfg), starts, ty0,
                               tiles_x, cfg)


def stream_forward(att, pid, starts, ty0: int, tiles_x: int, cfg: RenderConfig):
    """Front-to-back blend of every tile of the band.

    att [NH, 9] f32 home-row attributes (mean2d, conic, rgb, opacity —
    absolute means); pid [S] i32 sorted pair ids (sid = pid // 9); starts
    [T+1] i32 tile segment offsets into pid. Returns out [T, 8, ts²] f32
    (rows: rgb, T_act, C, n_done, 0, 0).

    Kernel C, csrc/stream_fwd.cu; replaces the TPU kernel
    gsjax/render/pallas_stream.py::_stream_fwd_kernel. CPU tensors take
    the plain version; CUDA tensors launch the kernel (there is no
    fallback). The kernel skips the pairs a warp's pixels cannot reach
    and stops a warp once all its pixels' C < eps: rows 0-3 and 5 are
    the full walk's bits, and row 4, the exit C, is too wherever it is ≥
    eps; elsewhere it stays below eps where the stop left it. No caller
    reads row 4 (blend_stream returns rows 0-3, the backward reads 0-3
    and 5)."""
    if att.device.type == "cpu":
        return stream_forward_plain(att, pid, starts, ty0, tiles_x, cfg)
    n_tiles = starts.shape[0] - 1
    check_kernel_args("stream_forward", cfg, att, att.dim() == 2, n_tiles,
                      (pid, starts))
    att, pid, starts = att.contiguous(), pid.contiguous(), starts.contiguous()
    n_px = cfg.tile_size * cfg.tile_size
    out = torch.empty((n_tiles, FWD_ROWS, n_px), dtype=torch.float32, device=att.device)
    err = kernels.lib().gsjax_stream_forward(
        att.data_ptr(), pid.data_ptr(), starts.data_ptr(), n_tiles, ty0,
        tiles_x, cfg.tile_size, cfg.chunk, cfg.tile_span * cfg.tile_span,
        cfg.alpha_clamp, cfg.alpha_min, cfg.transmittance_eps,
        out.data_ptr(), kernels.stream_ptr(att),
    )
    kernels.check(err, "stream_forward")
    kernels.LAUNCHES["stream_fwd"] += 1
    return out


def blend_backward_plain(rows, n_keys: int, starts, fwd_out, ct_img, ct_T,
                         ty0: int, tiles_x: int, cfg: RenderConfig,
                         stats: dict | None = None):
    """The plain VJP of blend_forward_plain, kernels D's and F's: each
    replayed pair's 9 gradients in row `key` of a buffer [n_keys, 9]
    (rows(t, k, valid) → (a, key), as for the forward; rows no replayed
    pair reaches stay 0). Tiles go in batches of similar chunk counts
    (sorted by n_done, as the forward batches by pair count); each batch
    replays its chunks in the forward's order from C = 1 with the
    forward's expressions (cumprod of f down a chunk), so the include
    decisions are the forward's, tiles leaving once their chunks are
    done. The suffix sums U come from the forward's image (fwd_out rows
    0-2) less the running sums of w·rgb (a cumsum per channel).

    `stats`, where given, is filled with counts of the kernels' work
    under their grouping (BWD_PAIRS pairs reduced together over a warp
    of 32·BWD_PIXELS pixels, a warp stopping once its pixels' C < eps):
    the replayed (warp, pair)s and those with an included pixel, the
    (warp, group)s the warps visited and those they reduced, the
    replayed pair-pixels and those the stops skipped; and the pair-pixels
    the VJP needs: those before each pixel's C < eps, and the included
    ones."""
    dev = fwd_out.device
    ts, chunk = cfg.tile_size, cfg.chunk
    n_px = ts * ts
    counts = (starts[1:] - starts[:-1]).to(torch.int64)
    n_done = fwd_out[:, 5, 0].to(torch.int64)
    order = torch.argsort(n_done, descending=True, stable=True)
    nd_sorted = n_done[order].cpu()
    n_busy = int((nd_sorted > 0).sum())
    pix = torch.arange(n_px, device=dev)
    pxl, pyl = (pix % ts).to(torch.float32), (pix // ts).to(torch.float32)
    lane = torch.arange(chunk, device=dev)
    eps = cfg.transmittance_eps
    dout = torch.zeros((n_keys, 9), dtype=torch.float32, device=dev)
    if stats is not None:
        for name in _STATS:
            stats.setdefault(name, 0)

    for b0 in range(0, n_busy, _PLAIN_TILE_BATCH):
        tb = order[b0:b0 + _PLAIN_TILE_BATCH]
        cnt = counts[tb]
        nd = n_done[tb]
        px = ((tb % tiles_x) * ts).to(torch.float32)[:, None] + pxl
        py = ((tb // tiles_x + ty0) * ts).to(torch.float32)[:, None] + pyl
        ct = ct_img[tb]  # [b, n_px, 3]
        img = fwd_out[tb, 0:3].transpose(1, 2)  # the forward's image [b, n_px, 3]
        ctTT = ct_T[tb] * fwd_out[tb, 3]  # ct_T · T_act
        C = torch.ones((tb.shape[0], n_px), dtype=torch.float32, device=dev)
        pre = torch.zeros((tb.shape[0], n_px, 3), dtype=torch.float32, device=dev)
        for k in range(int(nd_sorted[b0])):
            act = torch.nonzero(k < nd).squeeze(1)
            pos = k * chunk + lane
            valid = pos[None, :] < cnt[act, None]  # [b, chunk]
            a, key = rows(tb[act], k, valid)
            a = a[:, None]  # [b, 1, chunk, 9]
            dx = px[act][:, :, None] - a[..., 0]  # [b, n_px, chunk]
            dy = py[act][:, :, None] - a[..., 1]
            power = gaussian_power(a[..., 2:5], dx, dy)
            G = fexp(power)
            raw = a[..., 8] * G
            alpha = torch.clamp(raw, max=cfg.alpha_clamp)
            eligible = valid[:, None, :] & (alpha >= cfg.alpha_min) & (power <= 0.0)
            f = torch.where(eligible, 1.0 - alpha, 1.0)
            incl = torch.cumprod(f, dim=-1)
            excl = torch.cat([torch.ones_like(incl[..., :1]), incl[..., :-1]], dim=-1)
            C0 = C[act][:, :, None]
            include = eligible & (C0 * incl >= eps)  # the forward's decisions
            T_i = C0 * excl
            w = torch.where(include, T_i * alpha, 0.0)
            cta = ct[act][:, :, None, :]  # [b, n_px, 1, 3]
            v = (cta[..., 0] * a[..., 5] + cta[..., 1] * a[..., 6]
                 + cta[..., 2] * a[..., 7])
            # U = Σ_{j>i} v_j·w_j = ct · (img − Σ_{j≤i} w_j·rgb_j)
            pre_c = pre[act][:, :, None, :] + torch.stack(
                [torch.cumsum(w * a[..., 5 + c], dim=-1) for c in range(3)], dim=-1)
            U = ((img[act][:, :, None, :] - pre_c) * cta).sum(dim=-1)
            dalpha = torch.where(include, v * T_i - (U + ctTT[act][..., None]) / f, 0.0)
            unclamped = raw < cfg.alpha_clamp
            dpow = torch.where(unclamped, dalpha * alpha, 0.0)
            ca, cb, cc = a[..., 2], a[..., 3], a[..., 4]
            datt = torch.stack(  # [b, chunk, 9]: sums over the tile's pixels
                [
                    x.sum(dim=1) for x in (
                        dpow * (ca * dx + cb * dy),
                        dpow * (cb * dx + cc * dy),
                        dpow * (-0.5 * dx * dx),
                        dpow * (-dx * dy),
                        dpow * (-0.5 * dy * dy),
                        w * cta[..., 0],
                        w * cta[..., 1],
                        w * cta[..., 2],
                        torch.where(unclamped, dalpha * G, 0.0),
                    )
                ],
                dim=-1,
            )
            dout[key[valid]] = datt[valid]
            if stats is not None:
                keep = strip_cull_plain(a[:, 0], px[act][:, 0], py[act][:, 0], cfg)
                _count_work(stats, include, T_i, valid, eps, eligible, keep)
            C[act] = (C0 * incl)[..., -1]
            pre[act] = pre_c[:, :, -1]
    return dout


_STATS = ("warp_pairs", "warp_pairs_included", "warp_groups", "warp_groups_reduced",
          "pair_pixels", "pair_pixels_stopped", "pair_pixels_live",
          "pair_pixels_eligible", "pair_pixels_included", "fwd_warp_pairs",
          "fwd_warp_pairs_kept", "fwd_pair_pixels_evaluated", "fwd_pair_pixels_culled",
          "fwd_pair_pixels_stopped", "fwd_eligible_skipped")


def _count_work(stats: dict, include, T_i, valid, eps: float, eligible, keep) -> None:
    """Add one chunk's counts to blend_backward_plain's `stats`: include,
    eligible and T_i (C before each pair) [b, n_px, chunk], valid [b,
    chunk], keep [b, chunk, n_warps] the forward's strip cull; the chunk a
    multiple of BWD_PAIRS. The backward's work under its grouping; the
    forward's under its warp rectangles, each (warp, pair) of the chunks
    run counted once as stopped (no pixel of the warp has C ≥ eps before
    the pair), else culled (the warp's mask bit is clear), else evaluated,
    and the eligible live pair-pixels in a (warp, pair) the forward skips
    (0 when the cull is conservative). Besides the kernels' work, the work
    the function needs: the pair-pixels before the pixel's C < eps (live),
    those of them where the pair is eligible (α and the transmittance),
    and the included ones (the colour, the gradients)."""
    b, n_px, chunk = include.shape
    warp_px, p = 32 * BWD_PIXELS, BWD_PAIRS
    nw, ng = n_px // warp_px, chunk // p
    m = valid.sum(dim=1)  # [b] pairs in the chunk
    wp = include.reshape(b, nw, warp_px, chunk).any(dim=2) & valid[:, None, :]
    # a warp visits group g iff some pixel's C ≥ eps before its first pair
    live = (T_i[..., ::p] >= eps).reshape(b, nw, warp_px, ng).any(dim=2)
    g_valid = (torch.arange(ng, device=m.device) * p)[None, :] < m[:, None]  # [b, ng]
    g_pairs = torch.clamp(m[:, None] - torch.arange(ng, device=m.device) * p, 0, p)
    visited = live & g_valid[:, None, :]
    stats["warp_pairs"] += int(m.sum()) * nw
    stats["warp_pairs_included"] += int(wp.sum())
    stats["warp_groups"] += int(visited.sum())
    stats["warp_groups_reduced"] += int((wp.view(b, nw, ng, p).any(dim=3) & visited).sum())
    stats["pair_pixels"] += int(m.sum()) * n_px
    stats["pair_pixels_stopped"] += int(((~live) * g_pairs[:, None, :]).sum()) * warp_px
    live_px = (T_i >= eps) & valid[:, None, :]
    stats["pair_pixels_live"] += int(live_px.sum())
    stats["pair_pixels_eligible"] += int((live_px & eligible).sum())
    stats["pair_pixels_included"] += int(include.sum())
    # the forward: its warps' pixels together, in the kernel's warp order
    ts = round(n_px ** 0.5)
    warp_of = fwd_warp_of_pixel(ts, T_i.device)
    fwd_px, nwf = 32 * FWD_PIXELS, n_px // (32 * FWD_PIXELS)
    running = (T_i >= eps)[:, torch.argsort(warp_of, stable=True)].view(
        b, nwf, fwd_px, chunk).any(dim=2) & valid[:, None, :]  # [b, nwf, chunk]
    kept = keep.transpose(1, 2) & valid[:, None, :]
    evaluated = running & kept
    stats["fwd_warp_pairs"] += int(m.sum()) * nwf
    stats["fwd_warp_pairs_kept"] += int(kept.sum())
    stats["fwd_pair_pixels_evaluated"] += int(evaluated.sum()) * fwd_px
    stats["fwd_pair_pixels_culled"] += int((running & ~kept).sum()) * fwd_px
    stats["fwd_pair_pixels_stopped"] += (int(m.sum()) * nwf - int(running.sum())) * fwd_px
    stats["fwd_eligible_skipped"] += int((live_px & eligible & ~evaluated[:, warp_of]).sum())


def stream_backward_plain(att, pid, starts, fwd_out, ct_img, ct_T, ty0: int,
                          tiles_x: int, cfg: RenderConfig, stats: dict | None = None):
    """Plain PyTorch version of kernel D (same contract as
    stream_backward): each pair's gradients land in row pid of a per-pair
    buffer that is summed per home row, as in the kernel's wrapper.
    `stats`: blend_backward_plain's counts of the kernel's work."""
    nh, k_slots = att.shape[0], cfg.tile_span * cfg.tile_span
    dpair = blend_backward_plain(pair_rows(att, pid, starts, cfg), nh * k_slots,
                                 starts, fwd_out, ct_img, ct_T, ty0, tiles_x, cfg,
                                 stats)
    return dpair.view(nh, k_slots, 9).sum(dim=1)


def stream_backward(att, pid, starts, fwd_out, ct_img, ct_T, ty0: int,
                    tiles_x: int, cfg: RenderConfig):
    """VJP of stream_forward: d_att [NH, 9] f32 for the cotangents ct_img
    [T, ts², 3] and ct_T [T, ts²] (of the blend's img and T_act), given
    the forward's inputs and its output fwd_out [T, 8, ts²] (the replay
    reads the image, rows 0-2, T_act, row 3, and n_done, row 5).

    Kernel D, csrc/stream_bwd.cu (the blend backward, then the class sum); replaces the TPU kernel
    gsjax/render/pallas_stream.py::_stream_bwd_kernel. CPU tensors take
    the plain version; CUDA tensors launch the kernel (there is no
    fallback)."""
    if att.device.type == "cpu":
        return stream_backward_plain(att, pid, starts, fwd_out, ct_img, ct_T,
                                     ty0, tiles_x, cfg)
    nh, k_slots = att.shape[0], cfg.tile_span * cfg.tile_span
    # the kernel writes and marks the rows of the pairs it replays; the
    # class sum reads only those, so dpair is never zeroed
    dpair = torch.empty((nh * k_slots, 9), dtype=torch.float32, device=att.device)
    replayed = torch.zeros(nh * k_slots, dtype=torch.uint8, device=att.device)
    stream_backward_pairs(dpair, replayed, att, pid, starts, fwd_out, ct_img, ct_T,
                          ty0, tiles_x, cfg)
    return home_class_sum(dpair, replayed, nh, k_slots)


def stream_backward_pairs(dpair, replayed, att, pid, starts, fwd_out, ct_img, ct_T,
                          ty0: int, tiles_x: int, cfg: RenderConfig) -> None:
    """Kernel D's blend: each replayed pair's 9 gradients into row pid of
    dpair [NH·K, 9] f32, and replayed[pid] = 1 (uint8 [NH·K], zeroed by
    the caller); other rows are left as they are. Contiguous tensors on
    the card."""
    n_tiles = starts.shape[0] - 1
    k_slots = cfg.tile_span * cfg.tile_span
    check_kernel_args("stream_backward", cfg, att, att.dim() == 2, n_tiles,
                      (pid, starts), (fwd_out, ct_img, ct_T))
    n_rows = att.shape[0] * k_slots
    if (dpair.shape != (n_rows, 9) or dpair.dtype != torch.float32
            or replayed.shape != (n_rows,) or replayed.dtype != torch.uint8
            or not (dpair.is_contiguous() and replayed.is_contiguous())):
        raise ValueError("stream_backward: expected contiguous float32 dpair "
                         "[NH·K, 9] and uint8 replayed [NH·K]")
    att, pid, starts = att.contiguous(), pid.contiguous(), starts.contiguous()
    fwd_out, ct_img, ct_T = fwd_out.contiguous(), ct_img.contiguous(), ct_T.contiguous()
    err = kernels.lib().gsjax_stream_backward(
        att.data_ptr(), pid.data_ptr(), starts.data_ptr(), fwd_out.data_ptr(),
        ct_img.data_ptr(), ct_T.data_ptr(), n_tiles, ty0, tiles_x,
        cfg.tile_size, cfg.chunk, k_slots, cfg.alpha_clamp, cfg.alpha_min,
        cfg.transmittance_eps, dpair.data_ptr(), replayed.data_ptr(),
        kernels.stream_ptr(att),
    )
    kernels.check(err, "stream_backward")
    kernels.LAUNCHES["stream_bwd"] += 1


def home_class_sum_plain(dpair, replayed, nh: int, k_slots: int):
    """Plain version of home_class_sum."""
    rows = torch.where(replayed.view(nh, k_slots, 1).bool(), dpair.view(nh, k_slots, 9), 0.0)
    return rows.sum(dim=1)


def home_class_sum(dpair, replayed, nh: int, k_slots: int):
    """d_home [NH, 9]: each home row's sum of its K class rows of dpair
    [NH·K, 9], over the rows replayed [NH·K] marks (the others may hold
    anything). Kernel D's second kernel (csrc/stream_bwd.cu,
    class_sum_kernel), launched by stream_backward; CPU tensors take the
    plain version."""
    if dpair.device.type == "cpu":
        return home_class_sum_plain(dpair, replayed, nh, k_slots)
    d_home = torch.empty((nh, 9), dtype=torch.float32, device=dpair.device)
    err = kernels.lib().gsjax_stream_class_sum(
        dpair.data_ptr(), replayed.data_ptr(), nh, k_slots, d_home.data_ptr(),
        kernels.stream_ptr(dpair))
    kernels.check(err, "stream_backward (class sum)")
    kernels.LAUNCHES["stream_class_sum"] += 1
    return d_home


class _BlendStream(torch.autograd.Function):
    @staticmethod
    def forward(ctx, att, pid, starts, ty0, tiles_x, cfg):
        out = stream_forward(att.detach(), pid, starts, ty0, tiles_x, cfg)
        ctx.save_for_backward(att, pid, starts, out)
        ctx.args = (ty0, tiles_x, cfg)
        return out[:, 0:3, :].transpose(1, 2).contiguous(), out[:, 3, :].contiguous()

    @staticmethod
    @trace.spanned("blend_bwd")
    def backward(ctx, ct_img, ct_T):
        att, pid, starts, out = ctx.saved_tensors
        if ct_img is None:
            ct_img = torch.zeros_like(out[:, 0:3, :].transpose(1, 2))
        if ct_T is None:
            ct_T = torch.zeros_like(out[:, 3, :])
        d_att = stream_backward(att.detach(), pid, starts, out, ct_img, ct_T,
                                *ctx.args)
        return d_att, None, None, None, None, None


def blend_stream(att, pid, starts, ty0: int, tiles_x: int, cfg: RenderConfig):
    """Stream tile blend: (img [T, ts², 3], T_act [T, ts²]), differentiable
    in att (kernel C forward, kernel D backward)."""
    return _BlendStream.apply(att, pid, starts, ty0, tiles_x, cfg)


def composite_tiles_stream(p, layout, bins, cam, cfg: RenderConfig):
    """Composite the tile band covered by `bins`. `p` are the HOME-ordered
    projected splats of homesort.build_home_layout and `bins` were built
    with anchor="home" over the same layout. Returns (img [band_rows·ts,
    tiles_x·ts, 3], aux) with the reference's aux keys."""
    if cfg.tile_span != 3:
        raise ValueError("stream backend requires tile_span == 3")
    pid, starts, n_dropped = clipped_pair_stream(bins, cfg)
    img_t, T_t = blend_stream(att_table(p), pid, starts, bins.ty0,
                              bins.tiles_x, cfg)
    img, T_map = assemble_band(img_t, T_t, bins, cfg)
    zero = torch.zeros((), dtype=torch.int32, device=img.device)
    aux = {
        "transmittance": T_map,
        "n_clamped": bins.n_clamped,
        "n_pairs": bins.n_pairs,
        "n_tile_overflow": zero,
        "n_pair_overflow": n_dropped + bins.n_repack_overflow,
        # no band scratch in the port: the tile-sharded path
        # (parallel/render_sharded._render_band) adds its band's prefilter
        # and slice drops
        "n_band_overflow": zero,
        "n_fat_overflow": layout.n_fat_overflow,
    }
    return img, aux
