"""gsjax_torch: the blend forward's strip cull and work counts (kernels C
and E's plain twins) and the constants they mirror from csrc/blend.cuh."""

import os
import re

import numpy as np
import pytest
import torch

import gsjax_torch as gt
from gsjax_torch import kernels
from gsjax_torch.render.common import gaussian_power
from gsjax_torch.render import fastmath, stream
from gsjax_torch.render.fastmath import fexp

from test_torch_blend_fwd_common import CHUNK, TS, X0, Y0, _pairs, _scene


def test_strip_cull_is_conservative():
    """Every pixel of the tile where a pair is eligible (blend_forward_plain's
    α ≥ α_min and power ≤ 0) lies in a warp the strip cull keeps the pair
    for; and the cull does drop pairs at warps they miss, partly for pairs
    that reach the tile."""
    att, n_edge = _pairs()
    cfg = gt.RenderConfig(chunk=CHUNK)
    a = att[None]  # one tile, [1, n, 9]
    keep = stream.strip_cull_plain(a, torch.tensor([X0]), torch.tensor([Y0]), cfg)[0]
    pix = torch.arange(TS * TS)
    px, py = X0 + (pix % TS).to(torch.float32), Y0 + (pix // TS).to(torch.float32)
    # blend_forward_plain's expressions, [1, n_px, n]
    dx = px[None, :, None] - a[:, None, :, 0]
    dy = py[None, :, None] - a[:, None, :, 1]
    power = gaussian_power(a[:, None, :, 2:5], dx, dy)
    alpha = torch.clamp(a[:, None, :, 8] * fexp(power), max=cfg.alpha_clamp)
    eligible = ((alpha >= cfg.alpha_min) & (power <= 0.0))[0]  # [n_px, n]
    warp_of = stream.fwd_warp_of_pixel(TS)
    missed = eligible & ~keep.T[warp_of]
    assert int(missed.sum()) == 0, (
        f"the cull drops {int(missed.sum())} eligible pair-pixels, pairs "
        f"{torch.nonzero(missed.any(0)).flatten()[:10].tolist()}")
    # the inputs reach the cases the cull must get right
    reached = eligible.any(0)
    # [n, n_warps]: the warps with an eligible pixel
    per_warp = torch.stack([eligible[warp_of == w].any(0) for w in range(keep.shape[1])], 1)
    assert n_edge > 500 and int(reached.sum()) > 800
    partly = reached & ~keep.all(1)
    assert int(partly.sum()) > 200  # pairs on the tile that some warp skips
    assert bool((keep & ~per_warp).any())  # the cull keeps some it need not
    op = att[:, 8]
    assert not bool(keep[op < cfg.alpha_min].any())  # below α_min: no warp
    assert bool(eligible[:, op == np.float32(cfg.alpha_min)].any())


def test_fexp_is_at_most_one():
    """The cull drops every pair with op < α_min because α = op·fexp(power)
    ≤ op where power ≤ 0: fexp(x) = poly(f)·2^n ≤ 1 needs poly(f) ≤ 2 for
    every float32 f in [0.5, 1] (n ≤ −1 there; n = 0 only at x = 0, where
    poly(0) = 1), checked with fastmath's Horner steps over all of them,
    and fexp itself on a dense sample of [−2, 0]."""
    f = torch.arange(np.float32(0.5).view(np.int32), np.float32(1.0).view(np.int32) + 1,
                     dtype=torch.int32).view(torch.float32)
    p = f * fastmath._C5 + fastmath._C4
    for c in (fastmath._C3, fastmath._C2, fastmath._C1, fastmath._C0):
        p = p * f + c
    assert float((p * f + 1.0).max()) <= 2.0
    x = torch.cat([-torch.logspace(-30, np.log10(2.0), 2_000_001), torch.zeros(1)])
    assert float(fexp(x.to(torch.float32)).max()) == 1.0


def test_forward_constants_match_the_kernel():
    """stream.FWD_PIXELS / FWD_WARP_W / CULL_DEGENERATE / CULL_WIDEN mirror
    csrc/blend.cuh's kFwdPixels, kFwdWarpW, kCullDegenerate and
    kCullWiden."""
    with open(os.path.join(kernels.CSRC, "blend.cuh")) as fh:
        src = fh.read()
    ints = dict(re.findall(r"constexpr int kFwd(Pixels|WarpW) = (\d+);", src))
    floats = dict(re.findall(r"constexpr float kCull(Degenerate|Widen) = (0x[0-9a-fp.+-]+)f;",
                             src))
    assert int(ints["Pixels"]) == stream.FWD_PIXELS
    assert int(ints["WarpW"]) == stream.FWD_WARP_W
    assert float.fromhex(floats["Degenerate"]) == stream.CULL_DEGENERATE
    assert float.fromhex(floats["Widen"]) == stream.CULL_WIDEN


@pytest.mark.parametrize("eps", [1e-4, 0.2])
def test_forward_work_counts(eps):
    """The plain replay's count of the forward's work under its warp
    rectangles: evaluated + culled + stopped pair-pixels are the pair-
    pixels of the chunks run; the cull keeps every eligible live pair-
    pixel's (warp, pair); included ≤ eligible < live; and warps stop."""
    att, pid, starts, bins, cfg = _scene(eps)
    with torch.no_grad():
        out = stream.stream_forward_plain(att, pid, starts, 0, bins.tiles_x, cfg)
        ct = torch.zeros((out.shape[0], TS * TS, 3))
        stats = {}
        stream.stream_backward_plain(att, pid, starts, out, ct, ct[..., 0], 0, bins.tiles_x,
                                     cfg, stats=stats)
    counts = (starts[1:] - starts[:-1]).to(torch.int64)
    replayed = int(torch.minimum(counts, out[:, 5, 0].to(torch.int64) * CHUNK).sum())
    fwd_px = 32 * stream.FWD_PIXELS
    assert stats["pair_pixels"] == replayed * TS * TS
    assert stats["fwd_warp_pairs"] * fwd_px == stats["pair_pixels"]
    assert (stats["fwd_pair_pixels_evaluated"] + stats["fwd_pair_pixels_culled"]
            + stats["fwd_pair_pixels_stopped"]) == stats["pair_pixels"]
    assert stats["fwd_eligible_skipped"] == 0
    assert 0 < stats["fwd_warp_pairs_kept"] < stats["fwd_warp_pairs"]
    assert stats["fwd_pair_pixels_culled"] > 0
    assert 0 < stats["pair_pixels_included"] <= stats["pair_pixels_eligible"]
    assert stats["pair_pixels_eligible"] < stats["pair_pixels_live"]
    assert stats["pair_pixels_eligible"] <= stats["fwd_pair_pixels_evaluated"]
    assert stats["fwd_pair_pixels_stopped"] > 0
