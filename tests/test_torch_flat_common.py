"""Helpers of the flat backend's tests (test_torch_flat*.py): tile
starts, pair streams and a scene's home rows."""

import dataclasses

import numpy as np
import torch

from conftest import make_random_scene

import gsjax_torch as gt
from gsjax_torch.render.binning import build_tile_bins
from gsjax_torch.render.composite import att_table, clipped_pair_stream
from gsjax_torch.render.homesort import build_home_layout
from gsjax_torch.render.project import project

torch.set_num_threads(2)

_FIELDS = ("means", "log_scales", "quats", "sh", "opacity_logits")
W, H = 96, 64
CHUNK, K = 32, 9


def _starts(case):
    """Tile segment offsets [T+1] for 40 tiles: random counts with empty
    tiles; every count a multiple of the chunk; or clipped by a pair cap
    (as clipped_pair_stream clips them)."""
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 3 * CHUNK, 40) * (rng.uniform(size=40) < 0.7)
    if case == "multiples":
        counts = rng.integers(0, 4, 40) * CHUNK
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    if case == "pair_cap":
        starts = np.minimum(starts, starts[-1] // 2)
    assert (np.diff(starts) == 0).any()
    return starts


def _pairs(rng, n=200):
    """att_rows [n, 9], pid_sorted [S] (unique pair ids < n·K) and starts."""
    starts = _starts("empty_tiles")
    s = int(starts[-1])
    pid = rng.choice(n * K, size=s, replace=False).astype(np.int32)
    att = rng.normal(size=(n, 9)).astype(np.float32)
    return att, pid, starts


def _scene_inputs(name):
    """A scene's home rows and pair stream at 96×64, chunk 32:
    test_torch_train.py's thin scene, or its fat-splat scene; a name
    "fat_eps0.2" sets transmittance_eps to 0.2."""
    name, _, eps = name.partition("_eps")
    rng = np.random.default_rng(0)
    if name == "thin":
        g = make_random_scene(rng, n=300, sh_degree=1, spread=1.2, z_range=(3.0, 8.0))
    else:
        g = make_random_scene(rng, n=300, sh_degree=1, spread=1.0, z_range=(2.0, 6.0))
        g = dataclasses.replace(g, log_scales=g.log_scales + 2.0)
    gp = gt.Gaussians.from_numpy(*(np.asarray(getattr(g, f)) for f in _FIELDS), device="cpu")
    cam = gt.Camera.create(fx=80.0, fy=80.0, width=W, height=H, device="cpu")
    cfg = gt.RenderConfig(backend="pallas", chunk=CHUNK, fat_max_blocks=64, fat_cap=2048,
                          **({"transmittance_eps": float(eps)} if eps else {}))
    with torch.no_grad():
        ph, layout = build_home_layout(project(gp, cam, cfg), cam, cfg)
        bins = build_tile_bins(ph, cam, cfg, anchor="home", layout=layout)
    assert int(layout.n_fat_overflow) == 0
    pid, starts, _ = clipped_pair_stream(bins, cfg)
    return att_table(ph), pid, starts, bins, cfg


def _cotangents(n_tiles, seed=4):
    rng = np.random.default_rng(seed)
    ct_img = torch.from_numpy(rng.normal(size=(n_tiles, 256, 3)).astype(np.float32))
    ct_T = torch.from_numpy(rng.normal(size=(n_tiles, 256)).astype(np.float32))
    return ct_img, ct_T
