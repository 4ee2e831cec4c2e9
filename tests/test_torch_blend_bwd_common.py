"""Helpers of the blend backward tests (test_torch_blend_bwd*.py)."""

import dataclasses
import os

import numpy as np
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


BWD_VARIANTS = blend_bwd_variants.VARIANTS.split(",")


def check_bwd_variant_edits_the_kernel(variant):
    """Each variant the tool builds by default edits blend.cuh as it
    says (every edit matched as often as it expects), and only the
    shipped grouping with no ablation leaves it unchanged."""
    with open(os.path.join(kernels.CSRC, "blend.cuh")) as fh:
        src = fh.read()
    out = blend_bwd_variants.variant_source(variant, src)
    assert (out == src) == (variant == f"{stream.BWD_PAIRS}x{stream.BWD_PIXELS}")
    assert "constexpr int kBwdPairs = " + variant.split("x")[0] + ";" in out
