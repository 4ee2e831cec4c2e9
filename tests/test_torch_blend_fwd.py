"""gsjax_torch: the blend forward's strip cull and warp stop (kernels C and
E, csrc/blend.cuh::blend_fwd_kernel), through their plain twins in
render/stream.py.

The kernel skips a pair at the warps whose pixel rectangle (strip) its
α_min ellipse cannot reach, and stops a warp once all its pixels' C <
eps; neither may change img, T_act or n_done. On the CPU that rests on
the cull being conservative: every pixel where blend_forward_plain's
eligibility holds lies in a warp whose mask bit the cull sets
(strip_cull_plain, the kernel's cull op for op). Also here: the constants
that mirror the kernel's grouping and cull, the variants
tools/blend_fwd_variants.py builds, and the forward's work counts that
chip_smoke.py reports (blend_backward_plain's stats)."""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from conftest import make_random_scene

import gsjax_torch as gt
from gsjax_torch import kernels
from gsjax_torch.render.binning import build_tile_bins
from gsjax_torch.render.common import gaussian_power
from gsjax_torch.render.composite import att_table, clipped_pair_stream
from gsjax_torch.render import fastmath, stream
from gsjax_torch.render.fastmath import fexp
from gsjax_torch.render.homesort import build_home_layout
from gsjax_torch.render.project import project
from gsjax_torch.tools import blend_fwd_variants

torch.set_num_threads(2)

_FIELDS = ("means", "log_scales", "quats", "sh", "opacity_logits")
W, H, CHUNK, K, TS = 96, 64, 32, 9, 16
X0, Y0 = 48.0, 32.0  # the test tile's top-left pixel


def _conics(rng, n, ratio):
    """n conics (a, b, c) of covariances with axes σ1 ∈ [0.2, 200] px and
    σ1 / σ2 ∈ ratio (log-uniform), at random angles."""
    s1 = np.exp(rng.uniform(np.log(0.2), np.log(200.0), n))
    s2 = s1 / np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1]), n))
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    # the inverse of R diag(s1², s2²) Rᵀ
    i1, i2 = 1.0 / s1 ** 2, 1.0 / s2 ** 2
    return np.stack([c * c * i1 + s * s * i2, c * s * (i1 - i2), s * s * i1 + c * c * i2], -1)


def _pairs(seed=3):
    """Pair rows [n, 9] (mean2d, conic, rgb, opacity) f32 around the tile at
    (X0, Y0): round, tiny, huge and needle-thin conics and a few that are
    degenerate or not positive definite; opacities below α_min, at it, one
    ulp above, just above, random, at α_clamp and 1; means in and near the
    tile, far off it, and placed so the ellipse's α_min edge passes through
    a pixel centre of the tile (or a hair inside or outside it): random
    ellipses, round ones at a warp rectangle's corner pixel, and needles
    whose axis runs through a pixel."""
    rng = np.random.default_rng(seed)
    cfg = gt.RenderConfig()
    amin = np.float32(cfg.alpha_min)
    conic = np.concatenate([_conics(rng, 1500, (1.0, 4.0)), _conics(rng, 1200, (4.0, 60.0)),
                            _conics(rng, 800, (60.0, 3000.0)),
                            np.array([[1.0, 1.0, 1.0], [0.5, 0.6, 0.5], [0.0, 0.0, 0.3],
                                      [1e-3, 0.0, -1e-3], [2.0, -1.9999, 2.0],
                                      [0.02, 0.01999, 0.02]] * 20)])
    n = conic.shape[0]
    op = rng.choice(np.array([amin * 0.5, np.nextafter(amin, np.float32(0)), amin,
                              np.nextafter(amin, np.float32(1)), amin * np.float32(1.001),
                              np.float32(cfg.alpha_clamp), np.float32(1.0)], np.float32), n)
    op = np.where(rng.uniform(size=n) < 0.4, rng.uniform(amin, 1.0, n), op).astype(np.float32)
    kind = rng.integers(0, 3, n)
    mean = np.where((kind == 0)[:, None], rng.uniform(-40, TS + 40, (n, 2)),
                    rng.uniform(-500, TS + 500, (n, 2)))
    # edge placement: a pixel p of the tile on the ellipse q(p − mean) = L
    p = rng.integers(0, TS, (n, 2)).astype(np.float64)
    th = rng.uniform(0, 2 * np.pi, n)
    u = np.stack([np.cos(th), np.sin(th)], -1)
    quad = (conic[:, 0] * u[:, 0] ** 2 + 2 * conic[:, 1] * u[:, 0] * u[:, 1]
            + conic[:, 2] * u[:, 1] ** 2)
    L = 2.0 * np.log(np.maximum(op.astype(np.float64), amin) / amin)
    r = np.sqrt(L / np.where(quad > 0, quad, 1.0)) * (1.0 + rng.choice([-1e-4, 0.0, 1e-4], n))
    edge = (kind == 2) & (quad > 0)
    mean = np.where(edge[:, None], p - u * r[:, None], mean)
    # round splats whose α_min circle passes a corner pixel of a warp's
    # rectangle (its point nearest the mean) within float rounding, and
    # needles aimed from far off the tile through one of its pixels
    k = 2000
    sig = np.exp(rng.uniform(np.log(0.3), np.log(50.0), k))
    op_r = rng.uniform(amin, 1.0, k).astype(np.float32)
    corner = np.stack([rng.choice([0, 7, 8, 15], k), rng.choice([0, 7, 8, 15], k)], -1)
    out = np.where(corner % 8 == 0, -1.0, 1.0)  # away from the rectangle
    th = rng.uniform(0.1, np.pi / 2 - 0.1, k)
    u = out * np.stack([np.cos(th), np.sin(th)], -1)
    r = sig * np.sqrt(2.0 * np.log(op_r / amin) * (1.0 + rng.uniform(-2e-6, 2e-6, k)))
    conic = np.concatenate([conic, np.stack([1 / sig ** 2, 0 * sig, 1 / sig ** 2], -1)])
    mean = np.concatenate([mean, corner + u * r[:, None]])
    op = np.concatenate([op, op_r])
    k = 1000
    axis = rng.uniform(0, 2 * np.pi, k)
    c, sn = np.cos(axis), np.sin(axis)
    s1 = np.exp(rng.uniform(np.log(100.0), np.log(300.0), k))  # σ2 0.01-0.1 px
    i1, i2 = 1.0 / s1 ** 2, (3000.0 / s1) ** 2 * np.exp(rng.uniform(0, np.log(10.0), k))
    conic = np.concatenate([conic, np.stack([c * c * i1 + sn * sn * i2, c * sn * (i1 - i2),
                                             sn * sn * i1 + c * c * i2], -1)])
    hit = rng.integers(0, TS, (k, 2))
    far = (s1 * rng.uniform(0.5, 1.5, k))[:, None]
    mean = np.concatenate([mean, hit + np.stack([c, sn], -1) * far])
    op = np.concatenate([op, rng.uniform(0.05, 1.0, k).astype(np.float32)])
    att = np.zeros((mean.shape[0], 9), np.float32)
    att[:, 0:2] = mean + (X0, Y0)
    att[:, 2:5] = conic
    att[:, 5:8] = rng.uniform(0, 1, (mean.shape[0], 3))
    att[:, 8] = op
    return torch.from_numpy(att), int(edge.sum())


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


@pytest.mark.parametrize("variant", blend_fwd_variants.VARIANTS.split(","))
def test_blend_fwd_variants_edit_the_kernel(variant):
    """Each variant the tool builds by default edits blend.cuh as it says
    (every edit matched as often as it expects), and only the shipped
    mapping with no ablation leaves it unchanged."""
    with open(os.path.join(kernels.CSRC, "blend.cuh")) as fh:
        src = fh.read()
    out = blend_fwd_variants.variant_source(variant, src)
    assert (out == src) == (variant == f"{stream.FWD_PIXELS}x{stream.FWD_WARP_W}")
    grouping = (blend_fwd_variants.BASELINE if variant == "baseline" else variant).split("+")
    pixels, width = grouping[0].split("x")
    assert f"constexpr int kFwdPixels = {pixels};" in out
    assert f"constexpr int kFwdWarpW = {width};" in out
    assert ("stage_warp_masks(sh, smask" in out) == ("no-cull" not in grouping)
    assert ("running = __any_sync" in out) == ("no-stop" not in grouping)


def _scene(eps):
    """(att, pid, starts, bins, cfg): test_torch_blend_bwd.py's 400-splat
    scene at 96×64, chunk 32, transmittance_eps = eps."""
    g = make_random_scene(np.random.default_rng(11), n=400, sh_degree=1, spread=1.2,
                          z_range=(3.0, 8.0))
    g = dataclasses.replace(g, log_scales=g.log_scales + 1.0)
    gp = gt.Gaussians.from_numpy(*(np.asarray(getattr(g, f)) for f in _FIELDS),
                                 device="cpu")
    cam = gt.Camera.create(fx=80.0, fy=80.0, width=W, height=H, device="cpu")
    cfg = gt.RenderConfig(chunk=CHUNK, transmittance_eps=eps, fat_max_blocks=64,
                          fat_cap=2048)
    with torch.no_grad():
        ph, layout = build_home_layout(project(gp, cam, cfg), cam, cfg)
        bins = build_tile_bins(ph, cam, cfg, anchor="home", layout=layout)
    pid, starts, _ = clipped_pair_stream(bins, cfg)
    return att_table(ph), pid, starts, bins, cfg


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
