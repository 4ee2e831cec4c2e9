"""Helpers of the tile-sharded path's parity tests
(test_torch_parallel_*.py): scenes, cameras, configurations, the numpy
bridge between the two packages' projected splats and home layouts, and
the gsjax side as module fixtures (each computed once, jitted).

tests/test_parallel.py's claims at the port's test budget: n ≤ 400,
cameras ≤ 96×144 (9 tile rows: the uneven split over 8 bands), chunk 32.
gsjax's kernels A and B run in interpret mode inside its home layout and
bins only; no gsjax blend kernel and no shard_map runs (its unsharded
references are its plain `xla` render)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import make_random_scene

import gsjax
import gsjax_torch as gt
from gsjax.render import homesort as jh
from gsjax.render.project import project as j_project
from gsjax_torch.core.gaussians import FIELDS
from gsjax_torch.render.homesort import HomeLayout
from gsjax_torch.render.project import ProjectedSplats

torch.set_num_threads(2)

KW = dict(fat_max_blocks=64, fat_cap=2048)
# tests/test_parallel.py's stream configuration (its TPU band knobs are
# no-ops in the port) and its xla one
STREAM_J = dict(backend="stream", chunk=32, stream_band_cap=4096, stream_block_tiles=3,
                stream_dma_chunk=256)
XLA = dict(backend="xla", tile_list_cap=256, chunk=64)
PCAM = dict(fx=120.0, fy=120.0)


def to_torch(g):
    return gt.Gaussians.from_numpy(*(np.asarray(getattr(g, f)) for f in FIELDS), device="cpu")


def cams(width, height):
    """(gsjax camera, port camera) at the origin looking down +z."""
    return (gsjax.Camera.create(**PCAM, width=width, height=height),
            gt.Camera.create(**PCAM, width=width, height=height, device="cpu"))


def scene(n=200, spread=1.2, seed=0, log_scale_boost=0.0, **kw):
    """make_random_scene's draws (tests/test_parallel.py's scenes), log
    scales raised by log_scale_boost (fat splats)."""
    g = make_random_scene(np.random.default_rng(seed), n=n, spread=spread, **kw)
    if log_scale_boost:
        g = dataclasses.replace(g, log_scales=g.log_scales + log_scale_boost)
    return g


def proj_to_torch(p) -> ProjectedSplats:
    f = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return ProjectedSplats(mean2d=f(p.mean2d), depth=f(p.depth), conic=f(p.conic),
                           radius=f(p.radius), rgb=f(p.rgb), opacity=f(p.opacity),
                           valid=f(p.valid))


def layout_to_torch(lay) -> HomeLayout:
    f = lambda a, dt=torch.int32: torch.from_numpy(np.array(a)).to(dt)  # noqa: E731
    return HomeLayout(perm=f(lay.perm, torch.int64), seg_starts=f(lay.seg_starts),
                      home_x=f(lay.home_x), home_y=f(lay.home_y), win=f(lay.win),
                      n_valid=f(lay.n_valid), n_fat_overflow=f(lay.n_fat_overflow),
                      n_copies=f(lay.n_copies), tiles_x=lay.tiles_x, tiles_y=lay.tiles_y)


def assert_proj_equal(a: ProjectedSplats, b, msg=""):
    """Port ProjectedSplats `a` bit-equal to gsjax's `b`."""
    for f in ("mean2d", "depth", "conic", "radius", "rgb", "opacity", "valid"):
        np.testing.assert_array_equal(getattr(a, f).detach().numpy(), np.asarray(getattr(b, f)),
                                      err_msg=f"{msg} {f}")


# the band tests' scene: fat splats (copy rows in the layout) over a
# 96×144 image, 9 tile rows
BAND_W, BAND_H = 96, 144
CFG_BAND_J = gsjax.RenderConfig(**STREAM_J, **KW)
CFG_BAND_T = gt.RenderConfig(backend="stream", chunk=32, **KW)


def band_scene():
    return scene(n=400, spread=1.4, z_range=(3.0, 8.0), log_scale_boost=1.0)


@pytest.fixture(scope="module")
def band_ref():
    """gsjax's projected splats and home layout of the band scene (kernel
    A in interpret mode), jitted once."""
    camj, _ = cams(BAND_W, BAND_H)
    g = band_scene()

    @jax.jit
    def prologue(g):
        p = j_project(g, camj, CFG_BAND_J)
        return (p,) + jh.build_home_layout(p, camj, CFG_BAND_J, return_extras=True)

    p, ph, lay, extras = prologue(g)
    return dict(g=g, p=p, ph=ph, lay=lay, extras=extras)
