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

import os
import re

import numpy as np
import pytest
import torch

import gsjax_torch as gt
from gsjax_torch import kernels
from gsjax_torch.render import stream

from test_torch_blend_bwd_common import (BWD_VARIANTS, CHUNK, K, _cotangents, _flip_tile,
                                         _scene, check_bwd_variant_edits_the_kernel)


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


@pytest.mark.parametrize("variant", BWD_VARIANTS[0:2])
def test_blend_bwd_variants_edit_the_kernel(variant):
    check_bwd_variant_edits_the_kernel(variant)


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
