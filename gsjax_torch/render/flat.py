"""Flat slot-stream backend (backend "pallas") — the PyTorch counterpart
of gsjax/render/pallas_flat.py, forward and backward.

The sorted pair stream is laid out in chunk-aligned slots: slot j holds
`chunk` consecutive sorted pairs of exactly one tile (a tile's segment is
padded up to a chunk multiple), and the pairs' attributes are gathered
once per frame into att_al [NCB, chunk, 9] (`chunked_pair_attrs`). The
blend then reads contiguous rows — where the stream backend
(render/stream.py) reads each pair's home row through its pair id — and
computes the same thing: the forward and backward tile loops are the
stream backend's (csrc/blend.cuh on the card, stream.blend_forward_plain
and blend_backward_plain on the CPU) with another row source, so the two
backends give the same bits.

Gradient routing: the blend's backward gives per-slot attribute
gradients [NCB, chunk, 9]; `gather_pair_attrs`'s VJP returns them to the
home rows as the reference does — invert the pair permutation with a
scatter-set (every live pair id occurs once among the slots, and every
dead lane carries the one sentinel id N·K, whose entry is discarded), row-
gather the slot gradients by pair id, sum the K class rows of each home
row. No float atomics; the result does not depend on scatter order.

Kernel E (`slots_forward`, csrc/slots_fwd.cu) replaces the TPU kernel
gsjax/render/pallas_flat.py::_fwd_kernel, kernel F (`slots_backward`,
csrc/slots_bwd.cu) its _bwd_kernel. The TPU's slot grid, resident output
blocks and dead-slot sentinel tiles are TPU plumbing: a CUDA block owns a
tile and walks its slots in a loop. The unroll padding of the slot tables
(`stream_unroll`) fed only the TPU stream kernels and is not ported.
"""

from __future__ import annotations

import torch

from gsjax_torch import kernels
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.render.stream import (FWD_ROWS, blend_backward_plain,
                                       blend_forward_plain, check_kernel_args)

ATT_COLS = 9  # mean2d(2), conic(3), rgb(3), opacity(1)


def slot_tables(starts, chunk: int, ncb: int):
    """Per-slot tile ids and pair-window starts for ncb slots
    (pallas_flat._slot_tables with unroll 1). starts [T+1] i32 tile
    segment offsets. Returns int32 (tile_of [ncb] — n_tiles for the dead
    slots past the last tile's —, win [ncb] the first pair position of
    each slot, cbase [T+1] each tile's first slot, valid_count [ncb] the
    slot's lanes that hold real pairs). No host synchronisation."""
    i32 = torch.int32
    dev = starts.device
    counts = starts[1:] - starts[:-1]
    cbase = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                       torch.cumsum((counts + chunk - 1) // chunk, 0).to(i32)])
    n_tiles = counts.shape[0]
    # cbase ≤ ncb − 1 always (Σ ⌈count/chunk⌉ ≤ S // chunk + T), so no
    # mark is dropped; tiles without slots share their successor's mark
    marks = torch.zeros(ncb + 1, dtype=i32, device=dev).index_add_(
        0, cbase[:-1].to(torch.int64), torch.ones(n_tiles, dtype=i32, device=dev))
    slot_ids = torch.arange(ncb, dtype=i32, device=dev)
    tile_of = (torch.cumsum(marks[:ncb], 0) - 1).to(i32)
    tile_of = torch.where(slot_ids < cbase[-1], tile_of, n_tiles)
    toc = torch.clamp(tile_of, max=n_tiles - 1).to(torch.int64)
    shift = starts[:-1] - cbase[:-1] * chunk  # [T]
    win = slot_ids * chunk + shift[toc]
    win = torch.minimum(torch.clamp(win, min=0), torch.clamp(starts[-1] - 1, min=0))
    valid_count = torch.clamp(starts[toc + 1] - win, 0, chunk)
    valid_count = torch.where(tile_of < n_tiles, valid_count, 0)
    return tile_of, win, cbase, valid_count.to(i32)


class _GatherPairAttrs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, att_rows_pad, pid_al, k_slots):
        n = att_rows_pad.shape[0] - 1
        ctx.save_for_backward(pid_al)
        ctx.n, ctx.k_slots = n, k_slots
        return att_rows_pad[torch.clamp(pid_al // k_slots, max=n).to(torch.int64)]

    @staticmethod
    def backward(ctx, d):
        (pid_al,) = ctx.saved_tensors
        n, k_slots = ctx.n, ctx.k_slots
        nk = n * k_slots
        flat = d.reshape(-1, ATT_COLS)
        m = flat.shape[0]
        # inv[pid] = the slot row of pair pid; culled pids (and the
        # sentinel's discarded entry inv[nk]) point at a zero pad row
        inv = torch.full((nk + 1,), m, dtype=torch.int32, device=d.device)
        inv.scatter_(0, pid_al.reshape(-1).to(torch.int64),
                     torch.arange(m, dtype=torch.int32, device=d.device))
        flat_pad = torch.cat([flat, flat.new_zeros((1, ATT_COLS))])
        d_rows = flat_pad[inv[:nk]].view(n, k_slots, ATT_COLS).sum(dim=1)
        return torch.cat([d_rows, d_rows.new_zeros((1, ATT_COLS))]), None, None


def gather_pair_attrs(att_rows_pad, pid_al, k_slots: int):
    """att_rows_pad [N+1, 9] (last row a zero dummy), pid_al [NCB, chunk]
    pair ids with the sentinel N·k_slots on dead lanes → att_al [NCB,
    chunk, 9], the rows att_rows_pad[min(pid // k_slots, N)].
    Differentiable in att_rows_pad through the scatter-set inversion of
    the module docstring."""
    return _GatherPairAttrs.apply(att_rows_pad, pid_al, k_slots)


def chunked_pair_attrs(att_rows, pid_sorted, starts, cfg: RenderConfig,
                       k_slots: int):
    """Build the chunk-aligned slot stream. att_rows [N, 9]; pid_sorted
    [S] i32 sorted pair ids; starts [T+1] i32. Returns (att_al [NCB,
    chunk, 9], tile_of [NCB] i32, cbase [T+1] i32) with NCB = S // chunk
    + T + 1."""
    chunk = cfg.chunk
    n = att_rows.shape[0]
    n_tiles = starts.shape[0] - 1
    ncb = pid_sorted.shape[0] // chunk + n_tiles + 1
    tile_of, win, cbase, valid_count = slot_tables(starts, chunk, ncb)
    pid_pad = torch.cat([pid_sorted, pid_sorted.new_zeros(chunk)])
    lane = torch.arange(chunk, dtype=torch.int32, device=pid_sorted.device)
    pid_al = pid_pad[(win[:, None] + lane).to(torch.int64)]  # [NCB, chunk]
    pid_al = torch.where(lane < valid_count[:, None], pid_al, n * k_slots)
    att_rows_pad = torch.cat([att_rows, att_rows.new_zeros((1, ATT_COLS))])
    return gather_pair_attrs(att_rows_pad, pid_al, k_slots), tile_of, cbase


def slot_rows(att_al, cbase, cfg: RenderConfig):
    """The flat backend's chunk rows for the plain blends (stream.pair_rows'
    contract): chunk k of tile t is slot cbase[t] + k, lane i its row
    (cbase[t] + k)·chunk + i of att_al [NCB·chunk, 9], which is also
    where the lane's gradient lands."""
    flat = att_al.reshape(-1, ATT_COLS)
    lane = torch.arange(cfg.chunk, device=att_al.device)

    def rows(t, k, valid):
        key = (cbase[t].to(torch.int64)[:, None] + k) * cfg.chunk + lane
        return torch.where(valid[..., None], flat[key], 0.0), key

    return rows


def slots_forward_plain(att_al, starts, cbase, tile_of, ty0: int, tiles_x: int,
                        band_rows: int, cfg: RenderConfig):
    """Plain PyTorch version of kernel E (same contract as
    slots_forward)."""
    del tile_of, band_rows  # the slot loop needs neither
    return blend_forward_plain(slot_rows(att_al, cbase, cfg), starts, ty0,
                               tiles_x, cfg)


def _slot_shapes_ok(att_al, starts, cbase, n_tiles: int, cfg: RenderConfig) -> bool:
    return (att_al.dim() == 3 and att_al.shape[1] == cfg.chunk
            and starts.shape == cbase.shape == (n_tiles + 1,))


def slots_forward(att_al, starts, cbase, tile_of, ty0: int, tiles_x: int,
                  band_rows: int, cfg: RenderConfig):
    """Front-to-back blend of every tile of the band over the slot stream
    (pallas_flat._fwd_call's arguments and result).

    att_al [NCB, chunk, 9] f32 slot attributes; starts [T+1] i32 tile
    segment offsets (a tile's pair count); cbase [T+1] i32 each tile's
    first slot; tile_of [NCB] i32 is kept for parity with the reference
    and not read. Returns out [T, 8, ts²] f32 (rows: rgb, T_act, C,
    n_done, 0, 0); a tile with no slot reads (0, 0, 0, 1, 1, 0, 0, 0).

    Kernel E, csrc/slots_fwd.cu; replaces the TPU kernel
    gsjax/render/pallas_flat.py::_fwd_kernel. CPU tensors take the plain
    version; CUDA tensors launch the kernel (there is no fallback)."""
    if att_al.device.type == "cpu":
        return slots_forward_plain(att_al, starts, cbase, tile_of, ty0, tiles_x,
                                   band_rows, cfg)
    n_tiles = tiles_x * band_rows
    shapes_ok = _slot_shapes_ok(att_al, starts, cbase, n_tiles, cfg)
    check_kernel_args("slots_forward", cfg, att_al, shapes_ok, n_tiles, (starts, cbase))
    att_al, starts, cbase = att_al.contiguous(), starts.contiguous(), cbase.contiguous()
    n_px = cfg.tile_size * cfg.tile_size
    out = torch.empty((n_tiles, FWD_ROWS, n_px), dtype=torch.float32,
                      device=att_al.device)
    err = kernels.lib().gsjax_slots_forward(
        att_al.data_ptr(), starts.data_ptr(), cbase.data_ptr(), n_tiles, ty0,
        tiles_x, cfg.tile_size, cfg.chunk, cfg.alpha_clamp, cfg.alpha_min,
        cfg.transmittance_eps, out.data_ptr(), kernels.stream_ptr(att_al),
    )
    kernels.check(err, "slots_forward")
    kernels.LAUNCHES["slots_fwd"] += 1
    return out


def slots_backward_plain(att_al, starts, cbase, tile_of, ty0: int, fwd_out,
                         ct_img, ct_T, tiles_x: int, band_rows: int,
                         cfg: RenderConfig):
    """Plain PyTorch version of kernel F (same contract as
    slots_backward)."""
    del tile_of, band_rows
    datt = blend_backward_plain(slot_rows(att_al, cbase, cfg), att_al.shape[0] * cfg.chunk,
                                starts, fwd_out, ct_img, ct_T, ty0, tiles_x, cfg)
    return datt.view(att_al.shape)


def slots_backward(att_al, starts, cbase, tile_of, ty0: int, fwd_out, ct_img,
                   ct_T, tiles_x: int, band_rows: int, cfg: RenderConfig):
    """VJP of slots_forward (pallas_flat._bwd_call's arguments, with the
    port's cotangent layout): datt [NCB, chunk, 9] f32 for the cotangents
    ct_img [T, ts², 3] and ct_T [T, ts²] of the blend's img and T_act,
    given the forward's inputs and its output fwd_out [T, 8, ts²] (row 4
    the exit C, row 5 n_done). Slots at or past a tile's n_done, padded
    lanes and dead slots read 0.

    Kernel F, csrc/slots_bwd.cu; replaces the TPU kernel
    gsjax/render/pallas_flat.py::_bwd_kernel. CPU tensors take the plain
    version; CUDA tensors launch the kernel (there is no fallback)."""
    if att_al.device.type == "cpu":
        return slots_backward_plain(att_al, starts, cbase, tile_of, ty0, fwd_out,
                                    ct_img, ct_T, tiles_x, band_rows, cfg)
    n_tiles = tiles_x * band_rows
    shapes_ok = _slot_shapes_ok(att_al, starts, cbase, n_tiles, cfg)
    check_kernel_args("slots_backward", cfg, att_al, shapes_ok, n_tiles, (starts, cbase),
                      (fwd_out, ct_img, ct_T))
    att_al, starts, cbase = att_al.contiguous(), starts.contiguous(), cbase.contiguous()
    fwd_out, ct_img, ct_T = fwd_out.contiguous(), ct_img.contiguous(), ct_T.contiguous()
    datt = torch.zeros_like(att_al)
    err = kernels.lib().gsjax_slots_backward(
        att_al.data_ptr(), starts.data_ptr(), cbase.data_ptr(), fwd_out.data_ptr(),
        ct_img.data_ptr(), ct_T.data_ptr(), n_tiles, ty0, tiles_x,
        cfg.tile_size, cfg.chunk, cfg.alpha_clamp, cfg.alpha_min,
        cfg.transmittance_eps, datt.data_ptr(), kernels.stream_ptr(att_al),
    )
    kernels.check(err, "slots_backward")
    kernels.LAUNCHES["slots_bwd"] += 1
    return datt


class _BlendSlots(torch.autograd.Function):
    @staticmethod
    def forward(ctx, att_al, starts, cbase, tile_of, ty0, tiles_x, band_rows, cfg):
        out = slots_forward(att_al.detach(), starts, cbase, tile_of, ty0, tiles_x,
                            band_rows, cfg)
        ctx.save_for_backward(att_al, starts, cbase, tile_of, out)
        ctx.args = (ty0, tiles_x, band_rows, cfg)
        return out[:, 0:3, :].transpose(1, 2).contiguous(), out[:, 3, :].contiguous()

    @staticmethod
    def backward(ctx, ct_img, ct_T):
        att_al, starts, cbase, tile_of, out = ctx.saved_tensors
        ty0, tiles_x, band_rows, cfg = ctx.args
        if ct_img is None:
            ct_img = torch.zeros_like(out[:, 0:3, :].transpose(1, 2))
        if ct_T is None:
            ct_T = torch.zeros_like(out[:, 3, :])
        datt = slots_backward(att_al.detach(), starts, cbase, tile_of, ty0, out,
                              ct_img, ct_T, tiles_x, band_rows, cfg)
        return datt, None, None, None, None, None, None, None


def blend_slots(att_al, starts, cbase, tile_of, ty0: int, tiles_x: int,
                band_rows: int, cfg: RenderConfig):
    """Slot-stream tile blend: (img [T, ts², 3], T_act [T, ts²]),
    differentiable in att_al (kernel E forward, kernel F backward)."""
    return _BlendSlots.apply(att_al, starts, cbase, tile_of, ty0, tiles_x,
                             band_rows, cfg)
