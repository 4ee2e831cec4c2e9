"""gsjax_torch: the blend backward's forward-order replay (kernels D's and
F's plain version, render/stream.py::blend_backward_plain).

Its rgb columns, which involve no division, are held to Σ_pixels w·ct_img
(autograd of the plain forward's image alone) on one-tile inputs where a
replay that rebuilds the transmittance at a chunk's entry in reverse (C_exit
/ Π f) decides one pair the other way from the forward; the work counts
that chip_smoke.py reports and bounds the kernels with; the constants that
mirror the kernel's grouping; the variants tools/blend_bwd_variants.py
builds; and kernel D's class sum. (The near-eps scenes of the autograd
comparison are cases of test_torch_train.py's and test_torch_flat.py's
autograd tests.)"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from conftest import make_random_scene

import gsjax_torch as gt
from gsjax_torch import kernels
from gsjax_torch.render import stream
from gsjax_torch.render.binning import build_tile_bins
from gsjax_torch.render.composite import att_table, clipped_pair_stream
from gsjax_torch.render.homesort import build_home_layout
from gsjax_torch.render.project import project
from gsjax_torch.tools import blend_bwd_variants

torch.set_num_threads(2)

_FIELDS = ("means", "log_scales", "quats", "sh", "opacity_logits")
W, H, CHUNK, K = 96, 64, 32, 9


def _scene(eps):
    """(att [NH, 9], pid, starts, bins, cfg) of a 400-splat scene at 96×64,
    chunk 32, with transmittance_eps = eps: test_torch_train.py's thin
    scene, wider and with splats e× larger, so that many pixels end near
    T ≈ eps and warps stop early."""
    g = make_random_scene(np.random.default_rng(11), n=400, sh_degree=1, spread=1.2,
                          z_range=(3.0, 8.0))
    g = dataclasses.replace(g, log_scales=g.log_scales + 1.0)
    gp = gt.Gaussians.from_numpy(*(np.asarray(getattr(g, f)) for f in _FIELDS),
                                 device="cpu")
    cam = gt.Camera.create(fx=80.0, fy=80.0, width=W, height=H, device="cpu")
    cfg = gt.RenderConfig(chunk=CHUNK, transmittance_eps=eps,
                          fat_max_blocks=64, fat_cap=2048)
    with torch.no_grad():
        ph, layout = build_home_layout(project(gp, cam, cfg), cam, cfg)
        bins = build_tile_bins(ph, cam, cfg, anchor="home", layout=layout)
    assert int(layout.n_fat_overflow) == 0
    pid, starts, _ = clipped_pair_stream(bins, cfg)
    return att_table(ph), pid, starts, bins, cfg


def _cotangents(n_tiles):
    rng = np.random.default_rng(4)
    return (torch.from_numpy(rng.normal(size=(n_tiles, 256, 3)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(n_tiles, 256)).astype(np.float32)))


def _flip_tile(direction: str, i: int):
    """(opacity [CHUNK + 4], eps) of a one-tile blend whose pixel 0 sits at
    the centre of every splat (G = 1 there, so α = opacity): CHUNK faint
    splats fill chunk 0, 4 stronger ones chunk 1, and eps is pixel 0's C
    after pair i of chunk 1 ("drop": exactly, so the forward includes the
    pair; "add": one ulp above, so it does not). Seeds are tried in order
    until the reverse rebuild of chunk 1's entry C decides pair i the
    other way."""
    for seed in range(1000):
        rng = np.random.default_rng(seed)
        op = np.concatenate([rng.uniform(0.02, 0.06, CHUNK),
                             rng.uniform(0.05, 0.3, 4)]).astype(np.float32)
        f = 1.0 - torch.from_numpy(op)
        prod = torch.cumprod(f[CHUNK:], 0)
        c = torch.cumprod(f[:CHUNK], 0)[-1] * prod  # as the forward computes it
        eps = c[i] if direction == "drop" else torch.nextafter(c[i], torch.tensor(2.0))
        if bool((c[-1] / prod[-1] * prod[i] >= eps) != (c[i] >= eps)):
            return op, float(eps)
    raise AssertionError(f"no input flips pair {i} ({direction})")


@pytest.mark.parametrize("direction,i", [("drop", 0), ("drop", 2), ("add", 0), ("add", 2)])
def test_backward_rgb_columns_are_weights_times_cotangent(direction, i):
    """d rgb = Σ_pixels w·ct_img with w the forward's own weights, on a
    tile where the reverse rebuild (C_exit / Π f at chunk 1's entry)
    would drop ("drop") or add ("add") pixel 0's pair CHUNK + i: the
    replay makes the forward's decision, so the pair's row holds pixel
    0's weight, or 0."""
    op, eps = _flip_tile(direction, i)
    n = op.shape[0]
    rng = np.random.default_rng(1)
    att = np.zeros((n, 9), np.float32)
    att[:, 2:5] = (0.5, 0.0, 0.5)  # conic; mean2d (0, 0): pixel 0's centre
    att[:, 5:8] = rng.uniform(0.1, 1.0, (n, 3))
    att[:, 8] = op
    leaf = torch.from_numpy(att).requires_grad_()
    pid = torch.arange(n, dtype=torch.int32) * K
    starts = torch.tensor([0, n], dtype=torch.int32)
    cfg = gt.RenderConfig(chunk=CHUNK, transmittance_eps=eps)
    out = stream.stream_forward_plain(leaf, pid, starts, 0, 1, cfg)
    c_exit = out[0, 4, 0].detach()
    prod = torch.cumprod(1.0 - torch.from_numpy(op[CHUNK:]), 0)
    assert (c_exit / prod[-1] * prod[i] >= eps) == (direction == "add")
    ct_img = torch.zeros((1, 256, 3))
    ct_img[0, 0] = 1.0  # pixel 0 only: d rgb of a pair = its weight there
    (d_auto,) = torch.autograd.grad((out[:, 0:3].transpose(1, 2) * ct_img).sum(), leaf)
    assert (float(d_auto[CHUNK + i, 5]) > 0) == (direction == "drop")
    d = stream.stream_backward(leaf.detach(), pid, starts, out.detach(), ct_img,
                               torch.zeros((1, 256)), 0, 1, cfg)
    torch.testing.assert_close(d[:, 5:8], d_auto[:, 5:8], rtol=1e-6, atol=0.0)


def test_backward_work_counts():
    """blend_backward_plain's counts of the kernels' work (their grouping
    of pairs and pixels) change nothing, add up, and at eps = 0.2 show
    warps that stop early and groups that need no reduction."""
    att, pid, starts, bins, cfg = _scene(0.2)
    with torch.no_grad():
        out = stream.stream_forward_plain(att, pid, starts, 0, bins.tiles_x, cfg)
        ct_img, ct_T = _cotangents(out.shape[0])
        args = (stream.pair_rows(att, pid, starts, cfg), att.shape[0] * K, starts, out,
                ct_img, ct_T, 0, bins.tiles_x, cfg)
        stats = {}
        d = stream.blend_backward_plain(*args, stats=stats)
        assert torch.equal(d, stream.blend_backward_plain(*args))
    counts = (starts[1:] - starts[:-1]).to(torch.int64)
    replayed = torch.minimum(counts, out[:, 5, 0].to(torch.int64) * CHUNK)
    assert stats["pair_pixels"] == int(replayed.sum()) * 256
    assert stats["warp_pairs"] * 32 * stream.BWD_PIXELS == stats["pair_pixels"]
    assert 0 < stats["warp_pairs_included"] < stats["warp_pairs"]
    groups = int(((replayed + stream.BWD_PAIRS - 1) // stream.BWD_PAIRS).sum())
    n_warps = 256 // (32 * stream.BWD_PIXELS)
    assert 0 < stats["warp_groups_reduced"] < stats["warp_groups"] < groups * n_warps
    assert 0 < stats["pair_pixels_stopped"] < stats["pair_pixels"]
    # the work the VJP needs: a warp stops only once none of its pixels
    # is live, and a pair is included only where its pixel is
    live, included = stats["pair_pixels_live"], stats["pair_pixels_included"]
    assert 0 < included < live <= stats["pair_pixels"] - stats["pair_pixels_stopped"]


def test_grouping_constants_match_the_kernel():
    """stream.BWD_PAIRS / BWD_PIXELS mirror csrc/blend.cuh's."""
    with open(os.path.join(kernels.CSRC, "blend.cuh")) as fh:
        src = fh.read()
    consts = dict(re.findall(r"constexpr int kBwd(Pairs|Pixels) = (\d+);", src))
    assert int(consts["Pairs"]) == stream.BWD_PAIRS
    assert int(consts["Pixels"]) == stream.BWD_PIXELS


@pytest.mark.parametrize("variant", blend_bwd_variants.VARIANTS.split(","))
def test_blend_bwd_variants_edit_the_kernel(variant):
    """Each variant the tool builds by default edits blend.cuh as it
    says (every edit matched as often as it expects), and only the
    shipped grouping with no ablation leaves it unchanged."""
    with open(os.path.join(kernels.CSRC, "blend.cuh")) as fh:
        src = fh.read()
    out = blend_bwd_variants.variant_source(variant, src)
    assert (out == src) == (variant == f"{stream.BWD_PAIRS}x{stream.BWD_PIXELS}")
    assert "constexpr int kBwdPairs = " + variant.split("x")[0] + ";" in out


def test_home_class_sum_reads_only_marked_rows():
    """Kernel D's class sum (plain version on the CPU): each home row's
    sum of its marked class rows; unmarked rows, which the card never
    initialises, are not read — garbage there changes nothing."""
    rng = np.random.default_rng(5)
    nh = 50
    dpair = rng.normal(size=(nh * K, 9)).astype(np.float32)
    marked = rng.uniform(size=nh * K) < 0.3
    want = np.where(marked[:, None], dpair, 0.0).reshape(nh, K, 9).sum(axis=1)
    dpair[~marked] = np.nan  # what an uninitialised buffer may hold
    got = stream.home_class_sum(torch.from_numpy(dpair),
                                torch.from_numpy(marked.astype(np.uint8)), nh, K)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
