"""Home-tile splat layout for the stream backend — the PyTorch counterpart
of gsjax/render/homesort.py.

The projected splats are re-laid out once per frame in (home tile, depth)
order. A splat's home tile is the center of the 3×3-tile block of its
footprint rect it is responsible for, so every pair's tile is one of 9
fixed class offsets from its home. EXACT footprints (the default): a
splat whose rect spans more than one block is split — one extra home row
per additional block, a copy of the parent's projected attributes homed
at that block's center and windowed to block ∩ rect; copy blocks the
ellipse cannot reach at alpha_min are culled. Budget overflow
(fat_max_blocks / fat_cap / fat_live_cap) is counted, never silent.
LEGACY (footprint_clamp=True): home = the mean's tile.

The layout's gather (`home_gather`) is differentiable: a primary row's
gradient routes back through the inverse sort permutation, and a copy
row's gradient sums onto its parent (`reduce_copy_segments`), so a fat
splat's parent gets the gradient of every block it covers.

The tile-sharded path (parallel/render_sharded.py) cuts a band's share
out on both sides of the layout: `band_prefilter` keeps the splats that
can reach the band before it (a gather whose backward is a gather, no
scatter-add), `slice_band_rows` the band's contiguous home rows after it.

Kernel A (`repeat_fat_parents`, csrc/repeat.cu) replaces the TPU's
gsjax/render/homesort.py::_repeat_kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch import kernels, trace
from gsjax_torch.core.camera import Camera
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.render.common import box_inside, box_qmin, depth_bits, f32_scalar, tile_rect
from gsjax_torch.render.project import HOME_COLS, ProjectedSplats, home_columns, home_splats

PCOLS = max(hi for _, hi in HOME_COLS.values())  # the fields' columns; a row has a zero more
_RPT_STEP = 2048  # fat_cap granularity, kept from the reference
_BIG = float(1 << 30)  # fb/fbe of the non-fat pad rows


def cull_threshold(opacity: torch.Tensor, alpha_min: float) -> torch.Tensor:
    """2·ln(max(op, α_min)/α_min) + 1e-3: the largest conic quadratic at
    which the splat still reaches alpha_min (plus slack for fexp). One
    torch computation shared by the kernels and their plain versions, so
    a device `logf` can never flip a borderline cull between them."""
    a = f32_scalar(alpha_min, opacity)
    return 2.0 * torch.log(torch.maximum(opacity, a) / a) + 1e-3


def _block_qmin(mx, my, ca, cb, cc, wx0, wx1, wy0, wy1, ts: float):
    """min of the conic quadratic over the window's pixel rect
    [wx0·ts, wx1·ts − 1] × [wy0·ts, wy1·ts − 1] (the closed form of
    binning's per-tile ellipse cull, at block granularity)."""
    dxl = wx0.to(torch.float32) * ts - mx
    dxr = wx1.to(torch.float32) * ts - 1.0 - mx
    dyl = wy0.to(torch.float32) * ts - my
    dyr = wy1.to(torch.float32) * ts - 1.0 - my
    qmin = box_qmin(ca, cb, cc, -cb / cc, -cb / ca, dxl, dxr, dyl, dyr)
    return torch.where(box_inside(dxl, dxr, dyl, dyr), torch.zeros_like(qmin), qmin)


# --------------------------------------------------------------------------
# kernel A: fat-parent ragged repeat + per-copy block math
# --------------------------------------------------------------------------


def slot_parents(fb, fbe, nc: int, fat_cap: int):
    """Each copy slot's parent row: (par [fat_cap] i64, the last row with
    fb ≤ slot, clamped to ≥ 0; has [fat_cap] bool: the slot lies below
    fbe there and below nc)."""
    slot_i = torch.arange(fat_cap, dtype=torch.int32, device=fb.device)
    slot = slot_i.to(torch.float32)
    par = torch.searchsorted(fb, slot, right=True) - 1
    parc = par.clamp(min=0)
    return parc, (slot_i < nc) & (par >= 0) & (slot < fbe[parc])


def repeat_fat_parents_plain(src18, fb, fbe, n_copies, fat_cap: int,
                             tiles_x: int, tiles_y: int, span: int, ts: int,
                             alpha_min: float):
    """Plain PyTorch version of kernel A (same contract as
    repeat_fat_parents)."""
    thr = cull_threshold(src18[:, 6], alpha_min)
    nc = min(int(n_copies), fat_cap)
    slot_i = torch.arange(fat_cap, dtype=torch.int32, device=src18.device)
    slot = slot_i.to(torch.float32)
    parc, has = slot_parents(fb, fbe, nc, fat_cap)
    a = torch.where(has[:, None], src18[parc], torch.zeros_like(src18[:1]))
    th = torch.where(has, thr[parc], torch.zeros_like(slot))
    col = lambda i: a[:, i]
    toi = lambda i: a[:, i].to(torch.int32)

    h = span // 2
    b = (slot - col(0) + 1.0).to(torch.int32)  # block index 1..nb-1
    gsbx = torch.clamp(toi(12), min=1)
    bx = b % gsbx
    by = b // gsbx
    cwx0 = toi(13) + span * bx
    cwx1 = torch.minimum(cwx0 + span, toi(15))
    cwy0 = toi(14) + span * by
    cwy1 = torch.minimum(cwy0 + span, toi(16))
    chx = torch.clamp(cwx0 + h, max=tiles_x - 1)
    chy = torch.clamp(cwy0 + h, max=tiles_y - 1)
    qmin = _block_qmin(col(1), col(2), col(3), col(4), col(5),
                       cwx0, cwx1, cwy0, cwy1, float(ts))
    ok = (slot_i < nc) & (qmin <= th)
    hk = torch.where(ok, (chy * tiles_x + chx).to(torch.float32),
                     f32_scalar(tiles_x * tiles_y, a))
    dep = torch.where(ok, col(7), f32_scalar(1.0, a))
    cw = [torch.clamp(c.to(torch.float32), 0.0, 16383.0)
          for c in (cwx0, cwx1, cwy0, cwy1)]
    keys = torch.stack([hk, dep, cw[0] * 16384.0 + cw[1], cw[2] * 16384.0 + cw[3]])
    zero = torch.zeros_like(slot)
    tail = torch.stack(
        [col(1), col(2), col(7), col(3), col(4), col(5), col(8),
         col(9), col(10), col(11), col(6), zero], dim=1,
    )
    return tail, keys


def repeat_fat_parents(src18, fb, fbe, n_copies, fat_cap: int, tiles_x: int,
                       tiles_y: int, span: int, ts: int, alpha_min: float):
    """Ragged-repeat the fat parents' rows over the copy-slot axis, with
    the per-copy block decode, window, home tile and exact block ellipse
    cull fused in.

    src18 [NF, 18] f32: fat-compacted parent rows (col 0 = base, the first
    copy slot; 1-2 mean2d; 3-5 conic; 6 opacity; 7 depth; 8 radius; 9-11
    rgb; 12 blocks per row; 13-16 rect x0, y0, x1, y1; 17 n_ex); fb / fbe
    [NF] f32: base / base + n_ex, fb ascending (the fat parents' bases
    strictly), 2^30 on non-fat pad rows; n_copies: the live copy count.
    Slot j's parent is the last row with fb ≤ j, if j < fbe there and j <
    nc = min(n_copies, fat_cap). Returns
      tail_tab [fat_cap, 12] f32 — parent attributes (mean2, depth, conic,
        radius, rgb, opacity, 0); zero where no parent covers the slot;
      keys [4, fat_cap] f32 — row 0 home key (tiles_x·tiles_y sentinel
        when dead or culled), row 1 depth (1.0 when dead or culled), rows
        2/3 the copy window packed base 16384 (wx0·16384 + wx1,
        wy0·16384 + wy1). (The TPU kernel's rows 4-7, zero padding to 8
        sublanes that no caller reads, are not kept.)

    Kernel A, csrc/repeat.cu; replaces the TPU kernel
    gsjax/render/homesort.py::_repeat_kernel. CPU tensors take the plain
    version; CUDA tensors launch the kernel (there is no fallback)."""
    if src18.device.type == "cpu":
        return repeat_fat_parents_plain(src18, fb, fbe, n_copies, fat_cap,
                                        tiles_x, tiles_y, span, ts, alpha_min)
    if src18.device.type != "cuda":
        raise ValueError(f"repeat_fat_parents: unsupported device {src18.device}")
    src18 = src18.to(torch.float32).contiguous()
    fb = fb.to(torch.float32).contiguous()
    fbe = fbe.to(torch.float32).contiguous()
    nf = src18.shape[0]
    if src18.shape != (nf, 18) or fb.shape != (nf,) or fbe.shape != (nf,):
        raise ValueError("repeat_fat_parents: expected src18 [NF, 18], fb/fbe [NF]")
    thr = cull_threshold(src18[:, 6], alpha_min).contiguous()
    n_copies = torch.as_tensor(n_copies, dtype=torch.int64, device=src18.device)
    return launch_repeat(src18, fb, fbe, thr, n_copies, fat_cap, tiles_x, tiles_y, span, ts)


def launch_repeat(src18, fb, fbe, thr, n_copies, fat_cap: int, tiles_x: int, tiles_y: int,
                  span: int, ts: int):
    """Launch kernel A on repeat_fat_parents' CUDA inputs (thr [NF] f32:
    the parents' cull_threshold; n_copies: a 0-d i64 on the card, which
    the kernel reads there, so no host sync) without waiting for it:
    (tail_tab, keys)."""
    nf = src18.shape[0]
    tail = torch.empty((fat_cap, 12), dtype=torch.float32, device=src18.device)
    keys = torch.empty((4, fat_cap), dtype=torch.float32, device=src18.device)
    err = kernels.lib().gsjax_repeat_fat_parents(
        src18.data_ptr(), fb.data_ptr(), fbe.data_ptr(), thr.data_ptr(),
        nf, n_copies.data_ptr(), fat_cap, tiles_x, tiles_y, span, ts,
        tail.data_ptr(), keys.data_ptr(), kernels.stream_ptr(src18),
    )
    kernels.check(err, "repeat_fat_parents")
    kernels.LAUNCHES["repeat"] += 1
    return tail, keys


# --------------------------------------------------------------------------
# layout
# --------------------------------------------------------------------------


def reduce_copy_segments(d_tail, seg_base):
    """[F, C] copy-row values → [N, C] per-parent sums; the copies of
    parent i are tail rows [seg_base[i], seg_base[i+1]).

    Block-bounded prefix differencing, as in the reference: a global f32
    cumsum's running magnitude grows ~sqrt(F)·|g| and small segments
    would difference two large numbers (242x relative error at 1M copy
    rows, tests/test_homegather_precision.py). Within each block of
    B = 1024 rows an inclusive prefix p and the block total T; a segment
    is shorter than B (fat_max_blocks < 1024, guarded in _exact_rows), so
    it spans at most two blocks and its sum is p[b-1] − p[a-1], plus
    T[block(a-1)] when it crosses a block edge."""
    f, c = d_tail.shape
    B = 1024
    nb = -(-f // B)
    dt = torch.nn.functional.pad(d_tail.to(torch.float32), (0, 0, 0, nb * B - f))
    p = torch.cumsum(dt.reshape(nb, B, c), dim=1)
    T = p[:, -1:, :].expand(nb, B, c)
    paug = torch.cat([p, T], dim=-1).reshape(nb * B, 2 * c)
    idx = torch.clamp(seg_base.to(torch.int64), max=f) - 1  # [N+1]
    pb = torch.where((idx >= 0)[:, None], paug[torch.clamp(idx, min=0)], 0.0)
    blk = torch.clamp(idx, min=0) // B
    cross = (blk[1:] > blk[:-1])[:, None]
    return (pb[1:, :c] - pb[:-1, :c]) + torch.where(cross, pb[:-1, c:], 0.0)


def reduce_home_rows(d, f: int, inv, inv_tail, seg_base):
    """[NH, C] home-row values → [N, C] splat-order values, the transpose
    of home_gather: primary rows route through the inverse permutation
    (an index ≥ NH was truncated and gets zero), copy rows sum onto their
    parents."""
    nh = d.shape[0]
    dpad = torch.cat([d, torch.zeros_like(d[:1])])
    take = lambda idx: dpad[torch.clamp(idx, max=nh)]
    dx = take(inv)
    if f:
        dx = dx + reduce_copy_segments(take(inv_tail), seg_base).to(d.dtype)
    return dx


def _kernel_rows(name: str, rows, **index):
    """Raise unless `rows` are float32 [R, 12] row tables, contiguous and
    16-byte aligned, and `index` int64 vectors, contiguous, all on one
    CUDA device (what the home gather kernels read)."""
    dev = next(iter(rows.values())).device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for k, t in rows.items():
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != PCOLS + 1
                or not t.is_contiguous() or t.data_ptr() % 16 or t.device != dev):
            raise ValueError(f"{name}: {k} must be a contiguous, 16-byte aligned float32 "
                             f"[R, {PCOLS + 1}] on {dev}, not {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    for k, t in index.items():
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name}: {k} must be a contiguous int64 vector on {dev}, not "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def launch_home_gather(x, tail_x, perm):
    """Kernel Q (csrc/home_gather.cu): cat([x, tail_x])[perm] in one pass,
    with no concatenated copy; a perm entry outside [0, N + F) traps."""
    _kernel_rows("home_gather", {"x": x, "tail_x": tail_x}, perm=perm)
    n, f, nh = x.shape[0], tail_x.shape[0], perm.shape[0]
    out = torch.empty((nh, x.shape[1]), dtype=torch.float32, device=x.device)
    if nh:
        err = kernels.lib().gsjax_home_gather_forward(
            x.data_ptr(), tail_x.data_ptr(), perm.data_ptr(), n, f, nh, out.data_ptr(),
            kernels.stream_ptr(x))
        kernels.check(err, "home_gather")
        kernels.LAUNCHES["home_gather_fwd"] += 1
    return out


def launch_reduce_home_rows(d, inv, inv_tail, seg_base):
    """Kernel Q' (csrc/home_gather.cu): reduce_home_rows(d, F, inv,
    inv_tail, seg_base) with each copy segment summed from its own rows
    in a fixed order (no cumsum, no atomics)."""
    _kernel_rows("reduce_home_rows", {"d": d}, inv=inv, inv_tail=inv_tail, seg_base=seg_base)
    n, f = inv.shape[0], inv_tail.shape[0]
    if seg_base.shape[0] != n + 1:
        raise ValueError(f"reduce_home_rows: seg_base has {seg_base.shape[0]} entries, not "
                         f"N + 1 = {n + 1}")
    dx = torch.empty((n, d.shape[1]), dtype=torch.float32, device=d.device)
    if n:
        err = kernels.lib().gsjax_home_gather_backward(
            d.data_ptr(), inv.data_ptr(), inv_tail.data_ptr(), seg_base.data_ptr(), n, f,
            d.shape[0], dx.data_ptr(), kernels.stream_ptr(d))
        kernels.check(err, "reduce_home_rows")
        kernels.LAUNCHES["home_gather_bwd"] += 1
    return dx


class _HomeGather(torch.autograd.Function):
    """CPU tensors take the plain versions (cat + index; reduce_home_rows),
    CUDA tensors the kernel pair Q, Q' (there is no fallback)."""

    @staticmethod
    def forward(ctx, x, tail_x, perm, inv, inv_tail, seg_base):
        ctx.save_for_backward(inv, inv_tail, seg_base)
        ctx.f = tail_x.shape[0]
        if x.device.type == "cpu":
            return torch.cat([x, tail_x])[perm]
        return launch_home_gather(x, tail_x, perm)

    @staticmethod
    @trace.spanned("layout_bwd")
    def backward(ctx, d):
        inv, inv_tail, seg_base = ctx.saved_tensors
        if d.device.type == "cpu":
            dx = reduce_home_rows(d, ctx.f, inv, inv_tail, seg_base)
        else:
            dx = launch_reduce_home_rows(d.contiguous(), inv, inv_tail, seg_base)
        return dx, None, None, None, None, None


def home_gather(x, tail_x, perm, inv, inv_tail, seg_base):
    """concat(x [N, C], tail_x [F, C])[perm], differentiable in x.

    `tail_x` holds the fat-splat copy rows, each an exact copy of its
    parent's row of `x` (a stop-gradient copy: its gradient reaches x
    through the segment sum, not through tail_x). `inv` [N] / `inv_tail`
    [F]: each pre-sort row's position in the output (≥ len(perm) ⇒
    truncated ⇒ zero gradient); `seg_base` [N+1]: the copies of parent i
    are tail rows [seg_base[i], seg_base[i+1])."""
    return _HomeGather.apply(x, tail_x, perm, inv, inv_tail, seg_base)


@dataclasses.dataclass(frozen=True)
class HomeLayout:
    """perm [NH] i64: home row i holds pre-sort entry perm[i] (entries
    ≥ N are fat-splat copies); seg_starts [T+2] i32: home rows of tile t
    are [seg_starts[t], seg_starts[t+1]) (segment T holds culled rows);
    home_x / home_y [NH] i32; win [NH, 4] i32 (wx0, wx1, wy0, wy1): the
    row's tile window (block ∩ rect in exact mode, zeros in legacy mode);
    n_fat_overflow: footprint blocks / rows lost to the fat budgets."""

    perm: torch.Tensor
    seg_starts: torch.Tensor
    home_x: torch.Tensor
    home_y: torch.Tensor
    win: torch.Tensor
    n_valid: torch.Tensor
    n_fat_overflow: torch.Tensor
    n_copies: torch.Tensor
    tiles_x: int
    tiles_y: int


def resolve_fat_caps(n: int, cfg: RenderConfig):
    """Fat-split budgets (fat_cap, live_cap): fat_cap bounds the copy
    enumeration (pre block-cull), live_cap the copy rows kept in the
    sorted layout. None-configured caps scale with the scene."""
    fat_cap = cfg.fat_cap
    if fat_cap is None:
        fat_cap = min(4_194_304, max(1024, 2 * n))
    fat_cap = -(-fat_cap // _RPT_STEP) * _RPT_STEP
    if fat_cap >= 1 << 24:
        # slot indices ride the repeat kernel as f32 values
        raise ValueError(
            f"fat_cap={fat_cap} >= 2^24 breaks the f32-exactness of the "
            "copy-slot columns; use a smaller cap (overflow is counted)"
        )
    live_cap = cfg.fat_live_cap
    if live_cap is None:
        live_cap = min(2_097_152, max(1024, n + n // 4))
    return fat_cap, min(live_cap, fat_cap)


def _legacy_home(p, tiles_x, tiles_y, cfg):
    """Home = the mean's tile, clipped; splats more than 2 tiles outside
    the viewport go to the sentinel segment."""
    mx, my = p.mean2d[:, 0], p.mean2d[:, 1]
    ts = cfg.tile_size
    htx = torch.clamp(torch.floor(mx / ts).to(torch.int32), 0, tiles_x - 1)
    hty = torch.clamp(torch.floor(my / ts).to(torch.int32), 0, tiles_y - 1)
    on = (
        p.valid
        & (mx >= -ts * 2)
        & (mx < tiles_x * ts + ts * 2)
        & (my >= -ts * 2)
        & (my < tiles_y * ts + ts * 2)
    )
    return htx, hty, on


def _footprint_blocks(p, tiles_x, tiles_y, cfg):
    """Each splat's exact tile rect cut into span×span-tile blocks:
    (on, x0, y0, x1, y1, sbx, nb_full, n_blocks, n_ex); n_ex = the copy
    rows a fat splat needs beyond its primary (0 for thin / culled)."""
    span = cfg.tile_span
    x0, y0, x1, y1 = tile_rect(p.mean2d.detach(), p.radius.detach(),
                               tiles_x, tiles_y, cfg.tile_size)
    on = p.valid & (x1 > x0) & (y1 > y0)
    sbx = -(-(x1 - x0) // span)  # blocks per axis (≥ 1 when on)
    sby = -(-(y1 - y0) // span)
    nb_full = torch.where(on, sbx * sby, torch.ones_like(sbx))
    n_blocks = torch.clamp(nb_full, max=cfg.fat_max_blocks)
    n_ex = torch.where(on, n_blocks - 1, torch.zeros_like(n_blocks))
    return on, x0, y0, x1, y1, sbx, nb_full, n_blocks, n_ex


def fat_parent_table(p, x0, y0, x1, y1, sbx, n_ex):
    """Fat-compacted parent rows for kernel A: (src18 [N, 18], fb [N],
    fbe [N]). Fat splats (n_ex > 0) come first in index order; the rest
    are zero rows with fb = fbe = 2^30."""
    n = p.depth.shape[0]
    i2f = lambda v: v.to(torch.float32)
    base = torch.cumsum(n_ex, 0) - n_ex
    src18 = torch.cat(
        [
            i2f(base)[:, None], p.mean2d, p.conic, p.opacity[:, None],
            p.depth[:, None], p.radius[:, None], p.rgb,
            i2f(torch.stack([sbx, x0, y0, x1, y1], dim=-1)),
            i2f(n_ex)[:, None],
        ],
        dim=-1,
    ).detach()
    trace.host_sync(n_ex)
    fat_idx = torch.nonzero(n_ex > 0).squeeze(1)
    nf = fat_idx.shape[0]
    g18 = torch.zeros_like(src18)
    g18[:nf] = src18[fat_idx]
    fb = torch.full((n,), _BIG, dtype=torch.float32, device=src18.device)
    fbe = fb.clone()
    fb[:nf] = g18[:nf, 0]
    fbe[:nf] = g18[:nf, 0] + g18[:nf, 17]
    return g18, fb, fbe


def fat_repeat_inputs(p, tiles_x: int, tiles_y: int, cfg: RenderConfig):
    """Kernel A's inputs as build_home_layout forms them for the
    projected splats `p`: (src18, fb, fbe, n_copies)."""
    _, x0, y0, x1, y1, sbx, _, _, n_ex = _footprint_blocks(p, tiles_x, tiles_y, cfg)
    g18, fb, fbe = fat_parent_table(p, x0, y0, x1, y1, sbx, n_ex)
    return g18, fb, fbe, n_ex.sum(dtype=torch.int64)


def _exact_rows(p, tiles_x, tiles_y, cfg):
    """Exact-mode key material for the N primaries and the fat_cap copy
    slots: (home_key, depth, wpa, wpb, on_ext, tail_tab, n_ovf, n_copies,
    live_cap, seg_base, n_ex); seg_base [N+1]: parent i's copy slots are
    [seg_base[i], seg_base[i+1]), clipped at fat_cap; n_ex [N]: each
    splat's copy rows, unclipped."""
    if cfg.fat_max_blocks >= 1024:
        # the training VJP's block-bounded segment reduction needs every
        # parent's copy run shorter than 1024 rows (reference behaviour)
        raise ValueError(f"fat_max_blocks={cfg.fat_max_blocks} must be < 1024")
    n = p.depth.shape[0]
    span = cfg.tile_span
    h = span // 2
    t_sent = tiles_x * tiles_y
    on, x0, y0, x1, y1, sbx, nb_full, n_blocks, n_ex = _footprint_blocks(
        p, tiles_x, tiles_y, cfg
    )
    # primary row = block (0, 0); home = its center, clipped into the image
    phx = torch.clamp(x0 + h, max=tiles_x - 1)
    phy = torch.clamp(y0 + h, max=tiles_y - 1)
    pwa = x0 * 16384 + torch.minimum(x0 + span, x1)
    pwb = y0 * 16384 + torch.minimum(y0 + span, y1)

    fat_cap, live_cap = resolve_fat_caps(n, cfg)
    n_copies = n_ex.sum(dtype=torch.int64)
    base = torch.cumsum(n_ex.to(torch.int64), 0) - n_ex
    seg_base = torch.clamp(torch.cat([base, n_copies[None]]), max=fat_cap)
    g18, fb, fbe = fat_parent_table(p, x0, y0, x1, y1, sbx, n_ex)
    tail_tab, tkeys = repeat_fat_parents(
        g18, fb, fbe, n_copies, fat_cap, tiles_x, tiles_y, span,
        cfg.tile_size, cfg.alpha_min,
    )
    hk_tail = tkeys[0].to(torch.int32)
    tail_ok = hk_tail < t_sent  # dead / culled rows carry the sentinel
    home_key = torch.cat(
        [torch.where(on, phy * tiles_x + phx, torch.full_like(phx, t_sent)),
         hk_tail]
    )
    depth_all = torch.cat([p.depth.detach(), tkeys[1]])
    wpa = torch.cat([pwa, tkeys[2].to(torch.int32)])
    wpb = torch.cat([pwb, tkeys[3].to(torch.int32)])
    n_ovf = (
        torch.where(on, nb_full - n_blocks, torch.zeros_like(nb_full)).sum()
        + torch.clamp(n_copies - fat_cap, min=0)
    )
    return (home_key, depth_all, wpa, wpb, torch.cat([on, tail_ok]),
            tail_tab, n_ovf, n_copies, live_cap, seg_base, n_ex)


def sort_key(key_hi: torch.Tensor, dkey: torch.Tensor) -> torch.Tensor:
    """(key_hi << 32) | (dkey + 2^31) as int64: ascending in (key_hi,
    dkey). dkey is biased by 2^31 so the signed i32 order survives the
    packing (a culled row's depth may be negative)."""
    return (key_hi.to(torch.int64) << 32) | (dkey.to(torch.int64) + (1 << 31))


def sort_perm(key_hi: torch.Tensor, dkey: torch.Tensor) -> torch.Tensor:
    """Permutation sorting rows by (key_hi, dkey, row index), all
    ascending: one stable sort of sort_key's int64 key."""
    return torch.sort(sort_key(key_hi, dkey), stable=True).indices


def copy_slot_parents(n_ex, fat_cap: int):
    """The splat each copy slot belongs to, [fat_cap] i64, as the
    reference defines it (a mark at each fat splat's first slot, clamped
    to the last slot, and a running max): fat splat i (n_ex[i] > 0) owns
    slots [base[i], base[i] + n_ex[i]), base the exclusive cumsum of
    n_ex; a slot past the copy count, and the last slot when the copies
    overflow fat_cap, belong to the last fat splat (0 when there is
    none). Here the owner is a binary search of the bases (the last splat
    whose base is at most the slot: a thin splat's base is the next
    one's): torch's running max, a scan with indices, took 6.8 ms for the
    2.3M slots of the bonsai 1080p orbit on an H100 (a torch.profiler
    trace)."""
    base = torch.cumsum(n_ex, 0) - n_ex
    n_copies = base[-1] + n_ex[-1]
    idx = torch.arange(n_ex.shape[0], device=n_ex.device)
    last_fat = torch.where(n_ex > 0, idx, 0).amax()
    slot = torch.arange(fat_cap, device=n_ex.device)
    owner = torch.searchsorted(base, slot, right=True) - 1
    past = (slot >= n_copies) | ((slot == fat_cap - 1) & (n_copies > fat_cap))
    return torch.where(past, last_fat, owner)


@trace.spanned("layout")
def build_home_layout(p: ProjectedSplats, cam: Camera, cfg: RenderConfig,
                      return_extras: bool = False):
    """Sort the PROJECTED scene by (home tile, depth), splitting fat
    splats into per-block copies in exact mode. Returns
    (p_home: ProjectedSplats [NH], HomeLayout); NH = N + live_cap (exact)
    or N (legacy).

    With return_extras (exact mode), also a dict of what the lazy frame
    plans need (render/lazy.py): `inv` [N] / `inv_tail` [F] (each
    pre-sort row's home row, ≥ NH ⇒ truncated), `seg_base` [N+1] (the
    copy slots of each parent), `parent_of_slot` [F] (copy_slot_parents)
    and `src_sorted` [NH] (the source splat of each home row: the sorted
    permutation's own entry for a primary row, its slot's parent for a
    copy row)."""
    n = p.depth.shape[0]
    dev = p.depth.device
    tiles_x = cfg.tiles_x(cam.width)
    tiles_y = cfg.tiles_y(cam.height)
    if max(tiles_x, tiles_y) > 1023:
        # windows travel packed base 16384 and tile coordinates as f32
        # values: both exact only below 1024 tiles per axis
        raise ValueError(
            f"{tiles_x}x{tiles_y} tiles exceeds the 1023-per-axis bound "
            "of the packed window payloads; increase tile_size"
        )
    t_sent = tiles_x * tiles_y

    if return_extras and cfg.footprint_clamp:
        raise ValueError("return_extras needs exact footprints (footprint_clamp=False)")
    if cfg.footprint_clamp:
        htx, hty, on = _legacy_home(p, tiles_x, tiles_y, cfg)
        home_key = torch.where(on, hty * tiles_x + htx, torch.full_like(htx, t_sent))
        depth_all = torch.where(p.valid, p.depth.detach(), f32_scalar(1.0, p.depth))
        wpa = torch.zeros(n, dtype=torch.int32, device=dev)
        wpb = wpa
        on_ext = on
        tail_tab = torch.zeros((0, PCOLS + 1), dtype=torch.float32, device=dev)
        n_ovf = torch.zeros((), dtype=torch.int64, device=dev)
        n_copies = torch.zeros((), dtype=torch.int64, device=dev)
        seg_base = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        nh = n
    else:
        (home_key, depth_all, wpa, wpb, on_ext, tail_tab, n_ovf, n_copies,
         live_cap, seg_base, n_ex) = _exact_rows(p, tiles_x, tiles_y, cfg)
        nh = n + live_cap

    perm_full = sort_perm(home_key, depth_bits(depth_all))
    # the inverse permutation routes home-row gradients back; the indices
    # are unique, so this scatter is deterministic
    inv_ext = torch.empty_like(perm_full)
    inv_ext[perm_full] = torch.arange(perm_full.shape[0], device=dev)
    perm = perm_full[:nh]
    home_sorted = home_key[perm]
    n_live = on_ext.sum()
    n_ovf = n_ovf + torch.clamp(n_live - nh, min=0)
    seg_starts = torch.searchsorted(
        home_sorted,
        torch.arange(t_sent + 2, dtype=torch.int32, device=dev),
        side="left",
    ).to(torch.int32)

    packed_n = home_columns(p)  # [N, 12]; the tail rows carry the same column order
    ph = home_gather(packed_n, tail_tab, perm, inv_ext[:n], inv_ext[n:], seg_base)
    wpa_h, wpb_h = wpa[perm], wpb[perm]
    win = torch.stack(
        [wpa_h // 16384, wpa_h % 16384, wpb_h // 16384, wpb_h % 16384], dim=-1
    ).to(torch.int32)
    hs = torch.clamp(home_sorted, max=t_sent - 1)
    p_home = home_splats(ph, home_sorted < t_sent)  # liveness = the home-key sentinel
    layout = HomeLayout(
        perm=perm,
        seg_starts=seg_starts,
        home_x=(hs % tiles_x).to(torch.int32),
        home_y=(hs // tiles_x).to(torch.int32),
        win=win,
        n_valid=n_live.to(torch.int32),
        n_fat_overflow=n_ovf.to(torch.int32),
        n_copies=n_copies.to(torch.int32),
        tiles_x=tiles_x,
        tiles_y=tiles_y,
    )
    if not return_extras:
        return p_home, layout
    parent = copy_slot_parents(n_ex.to(torch.int64), tail_tab.shape[0])
    src_sorted = torch.where(perm < n, perm, parent[torch.clamp(perm - n, min=0)])
    extras = {"inv": inv_ext[:n], "inv_tail": inv_ext[n:], "seg_base": seg_base,
              "parent_of_slot": parent, "src_sorted": src_sorted}
    return p_home, layout, extras


# --------------------------------------------------------------------------
# the tile-sharded path: a band's prefilter and slice
# --------------------------------------------------------------------------


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


class _BandSelect(torch.autograd.Function):
    """packed[idx] whose backward is a gather through `inv` (not autograd's
    indexing VJP, an index_put with accumulate): `idx` [cap] are unique
    source rows (dead slots point at the zero pad row N), `inv` [N] each
    source row's output position (≥ cap: not selected, zero gradient)."""

    @staticmethod
    def forward(ctx, packed, idx, inv):
        ctx.save_for_backward(inv)
        ctx.n_pad = packed.shape[0]
        return packed[idx]

    @staticmethod
    def backward(ctx, d):
        (inv,) = ctx.saved_tensors
        cap = d.shape[0]
        dpad = torch.cat([d, torch.zeros_like(d[:1])])
        dx = dpad[torch.clamp(inv, max=cap)]
        return torch.nn.functional.pad(dx, (0, 0, 0, ctx.n_pad - dx.shape[0])), None, None


def band_prefilter_cap(n: int, tiles_y: int, band_rows: int, slack: float = 2.5) -> int:
    """Static splat budget of band_prefilter: the band's proportional
    share (band + 2 halo rows) times `slack` for density skew, rounded to
    4096."""
    cap = _ceil_to(int(n * (band_rows + 2) / max(tiles_y, 1) * slack), 4096)
    return min(_ceil_to(n, 4096), max(cap, 4096))


def band_prefilter(p: ProjectedSplats, ty0: int, band_rows: int, tiles_y: int,
                   tiles_x: int, cap_n: int, cfg: RenderConfig, return_idx: bool = False):
    """The splats whose footprint rect can reach the tile-row band
    [ty0 − 1, ty0 + band_rows + 1), compacted in index order to a static
    [min(cap_n, N)] prefix BEFORE build_home_layout, so a band's whole
    prologue runs on its share of the scene. Rows past the relevant ones
    are invalid zero rows (the pad row N). Relevant splats beyond cap_n
    are dropped far-index-first and counted. Gradients flow back through
    _BandSelect's gather.

    Returns (p_band, n_dropped); with return_idx also idx [min(cap_n, N)]
    i64, each row's splat (N for a pad row)."""
    n = p.depth.shape[0]
    dev = p.depth.device
    _, y0, _, y1 = tile_rect(p.mean2d.detach(), p.radius.detach(), tiles_x, tiles_y,
                             cfg.tile_size)
    relevant = p.valid & (y1 > ty0 - 1) & (y0 < ty0 + band_rows + 1)
    # unique keys: relevant splats keep their index, the rest shift by N,
    # so the sorted keys ARE the compacted order; the inverse is a scatter
    # of unique indices (deterministic)
    iota = torch.arange(n, device=dev)
    order_full = torch.sort(torch.where(relevant, iota, n + iota)).values
    inv_full = torch.empty_like(iota)
    inv_full[torch.where(order_full < n, order_full, order_full - n)] = iota
    order = order_full[:cap_n]
    live = order < n
    idx = torch.where(live, order, n)
    # a splat that is not relevant may sit below cap_n when the band
    # underfills it: its row is the zero pad, so its cotangent must not
    # route back
    inv_full = torch.where(relevant, inv_full, cap_n)
    n_dropped = torch.clamp(relevant.sum() - cap_n, min=0).to(torch.int32)
    packed = torch.cat([p.mean2d, p.depth[:, None], p.conic, p.radius[:, None], p.rgb,
                        p.opacity[:, None]], dim=-1)  # [N, 11]
    packed = torch.cat([packed, torch.zeros_like(packed[:1])])
    pb = _BandSelect.apply(packed, idx, inv_full)
    p_band = ProjectedSplats(
        mean2d=pb[:, 0:2], depth=pb[:, 2], conic=pb[:, 3:6],
        radius=torch.where(live, pb[:, 6], 0.0), rgb=pb[:, 7:10], opacity=pb[:, 10],
        valid=live,
    )
    if return_idx:
        return p_band, n_dropped, idx
    return p_band, n_dropped


def band_slice_cap(nh: int, tiles_y: int, band_rows: int, slack: float = 2.0) -> int:
    """Static home-row budget of slice_band_rows: the band's proportional
    share (band + 2 halo rows) times `slack`, rounded to 4096."""
    cap = _ceil_to(int(nh * (band_rows + 2) / max(tiles_y, 1) * slack), 4096)
    return min(_ceil_to(nh, 4096), max(cap, 4096))


def slice_band_rows(p: ProjectedSplats, layout: HomeLayout, ty0: int, band_rows: int,
                    cap: int, rows_live: int | None = None, extra_rows=()):
    """Restrict the home layout to the home rows of tile rows [ty0 − 1,
    ty0 + rows_live + 1) (rows_live defaults to band_rows): the rows that
    can emit pairs into the band's live rows. They are contiguous in the
    (home, depth) order, so this is one window of `cap` rows (the start
    read to the host once), a view of each array: its gradient is zero
    outside the window, as dynamic_slice's transpose pads it. Rows past
    cap are dropped far-end-first and counted (n_dropped); rows outside
    the band that ride along are masked by kernel B's band check.

    seg_starts becomes band-local, [(band_rows + 2)·tiles_x + 1] entries
    from tile row ty0 − 1, gathered at indices clamped to tiles_x·tiles_y
    (the end of the live rows), so a band past the image's last row reads
    no dead segment and an uneven split never shifts the table by a part
    of a row. Returns (p_band, layout_band, n_dropped); with extra_rows
    (per-home-row tensors) also those tensors' windows and the window's
    start."""
    tiles_x, tiles_y = layout.tiles_x, layout.tiles_y
    nh = layout.perm.shape[0]
    cap = min(cap, nh)
    if rows_live is None:
        rows_live = band_rows
    r0 = min(max(ty0 - 1, 0), tiles_y)
    r1 = min(max(ty0 + rows_live + 1, 0), tiles_y)
    start, end = layout.seg_starts[[r0 * tiles_x, r1 * tiles_x]].tolist()
    start_c = min(start, max(nh - cap, 0))
    dev = layout.seg_starts.device
    n_dropped = torch.tensor(max(end - start_c - cap, 0), dtype=torch.int32, device=dev)
    idx = torch.clamp(r0 * tiles_x + torch.arange((band_rows + 2) * tiles_x + 1, device=dev),
                      max=tiles_x * tiles_y)
    seg_local = torch.clamp(layout.seg_starts[idx] - start_c, 0, cap).to(torch.int32)
    sl = lambda a: a[start_c:start_c + cap]
    p2 = ProjectedSplats(mean2d=sl(p.mean2d), depth=sl(p.depth), conic=sl(p.conic),
                         radius=sl(p.radius), rgb=sl(p.rgb), opacity=sl(p.opacity),
                         valid=sl(p.valid))
    layout2 = dataclasses.replace(layout, perm=sl(layout.perm), seg_starts=seg_local,
                                  home_x=sl(layout.home_x), home_y=sl(layout.home_y),
                                  win=sl(layout.win))
    if extra_rows:
        return p2, layout2, n_dropped, [sl(a) for a in extra_rows], start_c
    return p2, layout2, n_dropped
