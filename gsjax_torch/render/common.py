"""Shared pieces of the rasterization pipeline — the PyTorch counterpart
of gsjax/render/common.py.

Depth ordering follows graphdeco: positive f32 depth bit patterns are
monotone as signed i32, so every ordering sorts on the raw depth bits.
"""

from __future__ import annotations

import torch

MAX_TILES = (1 << 30) - 1


def depth_bits(depth: torch.Tensor) -> torch.Tensor:
    """Monotone i32 key for positive f32 depths (the raw bit pattern)."""
    return depth.to(torch.float32).contiguous().view(torch.int32)


def tile_rect(mean2d, radius, tiles_x, tiles_y, tile_size):
    """Inclusive-min/exclusive-max tile rect per splat (graphdeco getRect):
    (x0, y0, x1, y1) int32; radius 0 gives an empty rect."""
    mx, my = mean2d[..., 0], mean2d[..., 1]

    def edge(v, hi):
        return torch.clamp(torch.floor(v / tile_size), 0, hi).to(torch.int32)

    return (
        edge(mx - radius, tiles_x),
        edge(my - radius, tiles_y),
        edge(mx + radius + tile_size - 1, tiles_x),
        edge(my + radius + tile_size - 1, tiles_y),
    )


def clamp_rect_to_span(x0, y0, x1, y1, mean2d, tile_size, span,
                       center_window: bool = True):
    """Clamp a tile rect to at most span×span tiles centered on the home
    tile; with `center_window` odd spans are also intersected with
    [home - span//2, home + span//2]. Returns (x0, y0, x1, y1, clamped)."""
    mtx = torch.floor(mean2d[..., 0] / tile_size).to(torch.int32)
    mty = torch.floor(mean2d[..., 1] / tile_size).to(torch.int32)
    clamped = (x1 - x0 > span) | (y1 - y0 > span)

    def clamp1(lo, hi, mt):
        over = hi - lo > span
        lo2 = torch.minimum(torch.maximum(mt - span // 2, lo),
                            torch.maximum(hi - span, lo))
        return torch.where(over, lo2, lo), torch.where(over, lo2 + span, hi)

    x0, x1 = clamp1(x0, x1, mtx)
    y0, y1 = clamp1(y0, y1, mty)
    if span % 2 == 1 and center_window:
        h = span // 2
        nx0 = torch.maximum(x0, mtx - h)
        nx1 = torch.minimum(x1, mtx + h + 1)
        ny0 = torch.maximum(y0, mty - h)
        ny1 = torch.minimum(y1, mty + h + 1)
        clamped = clamped | (nx0 != x0) | (nx1 != x1) | (ny0 != y0) | (ny1 != y1)
        x0, x1, y0, y1 = nx0, nx1, ny0, ny1
    return x0, y0, x1, y1, clamped


def gaussian_power(conic, dx, dy):
    """Log-weight -0.5(a dx² + c dy²) - b dx dy; conic [..., 3]."""
    a, b, c = conic[..., 0], conic[..., 1], conic[..., 2]
    return -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy


def box_qmin(ca, cb, cc, ncbrcc, ncbrca, dxl, dxr, dyl, dyr):
    """Min of the conic quadratic a·dx² + 2b·dx·dy + c·dy² over the box
    [dxl, dxr] × [dyl, dyr] of offsets from the mean, where the mean lies
    outside it: the least of the four edge minima, each edge's free
    coordinate at its clamped 1-D minimiser (ncbrcc = −b/c, ncbrca = −b/a).
    The expressions of csrc/common.cuh::box_qmin, op for op."""

    def quad(dx, dy):
        return ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy

    def edge_x(dx):
        return quad(dx, torch.minimum(torch.maximum(ncbrcc * dx, dyl), dyr))

    def edge_y(dy):
        return quad(torch.minimum(torch.maximum(ncbrca * dy, dxl), dxr), dy)

    return torch.minimum(torch.minimum(edge_x(dxl), edge_x(dxr)),
                         torch.minimum(edge_y(dyl), edge_y(dyr)))


def box_inside(dxl, dxr, dyl, dyr):
    """The mean lies in the box (csrc/common.cuh::box_inside)."""
    return (dxl <= 0) & (dxr >= 0) & (dyl <= 0) & (dyr >= 0)
