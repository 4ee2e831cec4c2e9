"""Stream backend tile blend — the PyTorch counterpart of
gsjax/render/pallas_stream.py (forward).

Splats are laid out once per frame in (home tile, depth) order
(render/homesort.py) and the pairs sorted by (tile, depth, pid)
(render/binning.py). The blend walks each tile's segment of the sorted
pair stream front to back in chunks of cfg.chunk pairs:

  α = min(alpha_clamp, op·fexp(power)); eligible iff α ≥ alpha_min and
  power ≤ 0; the virtual transmittance C multiplies every eligible pair's
  (1 − α) — termination is sticky at transmittance_eps — while the actual
  T_act tracks included pairs only; a tile exits at a chunk boundary once
  every pixel's C < eps.

Kernel C (`stream_forward`, csrc/stream_fwd.cu) replaces the TPU kernel
gsjax/render/pallas_stream.py::_stream_fwd_kernel. The TPU's band DMA,
pid windows, bf16 split table and slot grouping are TPU plumbing and have
no counterpart: the CUDA kernel reads exact f32 attributes by home row.
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


def stream_forward_plain(att, pid, starts, ty0: int, tiles_x: int,
                         cfg: RenderConfig):
    """Plain PyTorch version of kernel C (same contract as
    stream_forward). Tiles go in batches of similar pair counts (sorted
    by count, so a batch pads only to its own densest tile), one chunk at
    a time with a cumprod down the chunk; tiles that terminated or ran
    out of pairs leave the batch. No tile's list is truncated."""
    dev = att.device
    ts, chunk = cfg.tile_size, cfg.chunk
    n_px = ts * ts
    k_slots = cfg.tile_span * cfg.tile_span
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
    sid_of = (pid // k_slots).to(torch.int64)
    eps = cfg.transmittance_eps

    for b0 in range(0, n_busy, _PLAIN_TILE_BATCH):
        tb = order[b0:b0 + _PLAIN_TILE_BATCH]
        nb = tb.shape[0]
        cnt = counts[tb]
        st = starts[tb].to(torch.int64)
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
            idx = torch.where(valid, st[active, None] + pos, 0)
            a = torch.where(valid[..., None], att[sid_of[idx]], 0.0)  # [b, chunk, 9]
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
    if att.device.type != "cuda":
        raise ValueError(f"stream_forward: unsupported device {att.device}")
    n_px = cfg.tile_size * cfg.tile_size
    if att.dim() != 2 or att.shape[1] != 9 or att.dtype != torch.float32:
        raise ValueError("stream_forward: expected float32 att [NH, 9]")
    if pid.dtype != torch.int32 or starts.dtype != torch.int32:
        raise ValueError("stream_forward: pid and starts must be int32")
    if n_px > 1024 or cfg.chunk * 9 * 4 > 48 * 1024:
        raise ValueError("stream_forward: tile_size ≤ 32 and chunk ≤ 1365 supported")
    att, pid, starts = att.contiguous(), pid.contiguous(), starts.contiguous()
    n_tiles = starts.shape[0] - 1
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


class _BlendStream(torch.autograd.Function):
    @staticmethod
    def forward(ctx, att, pid, starts, ty0, tiles_x, cfg):
        out = stream_forward(att.detach(), pid, starts, ty0, tiles_x, cfg)
        return out[:, 0:3, :].transpose(1, 2).contiguous(), out[:, 3, :].contiguous()

    @staticmethod
    def backward(ctx, ct_img, ct_T):
        raise NotImplementedError(
            "the stream blend's gradient is not ported yet: ROADMAP queue 2 "
            "item D (stream backward kernel D)"
        )


def blend_stream(att, pid, starts, ty0: int, tiles_x: int, cfg: RenderConfig):
    """Stream tile blend: (img [T, ts², 3], T_act [T, ts²]). Forward only —
    its backward raises until the backward kernel is ported, so no
    gradient is ever silently wrong."""
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
