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
docstring): chunks replay in reverse from the forward's exit state (C and
n_done), C at a chunk's entry is rebuilt by division, and

  dL/dα_i = v_i·T_i − (U_i + ct_T·T_act)/(1−α_i),  v_i = rgb_i·ct_img,
  U_i = Σ_{j>i} v_j·w_j,

chained to mean2d, conic, rgb and opacity per pair. Near T ≈ eps the
rebuilt include set may differ from the forward's by one splat per pixel,
as in the reference.

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

from gsjax_torch import kernels
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.render.common import gaussian_power
from gsjax_torch.render.composite import assemble_band, att_table, clipped_pair_stream
from gsjax_torch.render.fastmath import fexp

FWD_ROWS = 8  # img(3), T_act, C, n_done, spare(2)
_PLAIN_TILE_BATCH = 256  # tiles per batch of the plain blend


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
    n_px = cfg.tile_size * cfg.tile_size
    if cotangents is None:
        if n_px > 1024 or cfg.chunk * 9 * 4 > 48 * 1024:
            raise ValueError(f"{name}: tile_size ≤ 32 and chunk ≤ 1365 supported")
        return
    shapes = {"fwd_out": (n_tiles, FWD_ROWS, n_px), "ct_img": (n_tiles, n_px, 3),
              "ct_T": (n_tiles, n_px)}
    for (what, shape), x in zip(shapes.items(), cotangents):
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 {what} {shape}")
    smem = 4 * cfg.chunk * (9 + (n_px // 32) * 9 + 1)
    if n_px % 32 or n_px > 1024 or smem > 227 * 1024:
        raise ValueError(f"{name}: tile_size² must be a multiple of 32 up to "
                         "1024, and the chunk's partial sums fit 227 KB")


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
    fallback)."""
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
                         ty0: int, tiles_x: int, cfg: RenderConfig):
    """The plain VJP of blend_forward_plain, kernels D's and F's: each
    replayed pair's 9 gradients in row `key` of a buffer [n_keys, 9]
    (rows(t, k, valid) → (a, key), as for the forward; rows no replayed
    pair reaches stay 0). Tiles go in batches of similar chunk counts
    (sorted by n_done, as the forward batches by pair count); each batch
    replays its chunks in reverse, tiles leaving once their chunks are
    done. The products and sums down a chunk run in the kernels' order
    (cumprod, cumsum)."""
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

    for b0 in range(0, n_busy, _PLAIN_TILE_BATCH):
        tb = order[b0:b0 + _PLAIN_TILE_BATCH]
        cnt = counts[tb]
        nd = n_done[tb]
        px = ((tb % tiles_x) * ts).to(torch.float32)[:, None] + pxl
        py = ((tb // tiles_x + ty0) * ts).to(torch.float32)[:, None] + pyl
        ct = ct_img[tb]  # [b, n_px, 3]
        ctTT = ct_T[tb] * fwd_out[tb, 3]  # ct_T · T_act
        C = fwd_out[tb, 4].clone()  # transmittance at the exit of chunk k
        S = torch.zeros_like(C)  # Σ v·w over the chunks after k
        for k in range(int(nd_sorted[b0]) - 1, -1, -1):
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
            C_entry = (C[act] / torch.clamp(incl[..., -1], min=1e-30))[..., None]
            include = eligible & (C_entry * incl >= eps)
            T_i = C_entry * excl
            w = torch.where(include, T_i * alpha, 0.0)
            cta = ct[act][:, :, None, :]  # [b, n_px, 1, 3]
            v = (cta[..., 0] * a[..., 5] + cta[..., 1] * a[..., 6]
                 + cta[..., 2] * a[..., 7])
            pre = torch.cumsum(v * w, dim=-1)
            tot = pre[..., -1:]
            U = S[act][..., None] + (tot - pre)
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
            C[act] = C_entry[..., 0]
            S[act] = S[act] + tot[..., 0]
    return dout


def stream_backward_plain(att, pid, starts, fwd_out, ct_img, ct_T, ty0: int,
                          tiles_x: int, cfg: RenderConfig):
    """Plain PyTorch version of kernel D (same contract as
    stream_backward): each pair's gradients land in row pid of a per-pair
    buffer that is summed per home row, as in the kernel's wrapper."""
    nh, k_slots = att.shape[0], cfg.tile_span * cfg.tile_span
    dpair = blend_backward_plain(pair_rows(att, pid, starts, cfg), nh * k_slots,
                                 starts, fwd_out, ct_img, ct_T, ty0, tiles_x, cfg)
    return dpair.view(nh, k_slots, 9).sum(dim=1)


def stream_backward(att, pid, starts, fwd_out, ct_img, ct_T, ty0: int,
                    tiles_x: int, cfg: RenderConfig):
    """VJP of stream_forward: d_att [NH, 9] f32 for the cotangents ct_img
    [T, ts², 3] and ct_T [T, ts²] (of the blend's img and T_act), given
    the forward's inputs and its output fwd_out [T, 8, ts²] (row 4 the
    exit C, row 5 n_done: the state the chunks replay from).

    Kernel D, csrc/stream_bwd.cu; replaces the TPU kernel
    gsjax/render/pallas_stream.py::_stream_bwd_kernel. CPU tensors take
    the plain version; CUDA tensors launch the kernel (there is no
    fallback)."""
    if att.device.type == "cpu":
        return stream_backward_plain(att, pid, starts, fwd_out, ct_img, ct_T,
                                     ty0, tiles_x, cfg)
    n_tiles = starts.shape[0] - 1
    k_slots = cfg.tile_span * cfg.tile_span
    check_kernel_args("stream_backward", cfg, att, att.dim() == 2, n_tiles,
                      (pid, starts), (fwd_out, ct_img, ct_T))
    att, pid, starts = att.contiguous(), pid.contiguous(), starts.contiguous()
    fwd_out, ct_img, ct_T = fwd_out.contiguous(), ct_img.contiguous(), ct_T.contiguous()
    nh = att.shape[0]
    dpair = torch.zeros((nh * k_slots, 9), dtype=torch.float32, device=att.device)
    err = kernels.lib().gsjax_stream_backward(
        att.data_ptr(), pid.data_ptr(), starts.data_ptr(), fwd_out.data_ptr(),
        ct_img.data_ptr(), ct_T.data_ptr(), n_tiles, ty0, tiles_x,
        cfg.tile_size, cfg.chunk, k_slots, cfg.alpha_clamp, cfg.alpha_min,
        cfg.transmittance_eps, dpair.data_ptr(), kernels.stream_ptr(att),
    )
    kernels.check(err, "stream_backward")
    kernels.LAUNCHES["stream_bwd"] += 1
    return dpair.view(nh, k_slots, 9).sum(dim=1)


class _BlendStream(torch.autograd.Function):
    @staticmethod
    def forward(ctx, att, pid, starts, ty0, tiles_x, cfg):
        out = stream_forward(att.detach(), pid, starts, ty0, tiles_x, cfg)
        ctx.save_for_backward(att, pid, starts, out)
        ctx.args = (ty0, tiles_x, cfg)
        return out[:, 0:3, :].transpose(1, 2).contiguous(), out[:, 3, :].contiguous()

    @staticmethod
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
        "n_band_overflow": zero,  # no band scratch in the port
        "n_fat_overflow": layout.n_fat_overflow,
    }
    return img, aux
