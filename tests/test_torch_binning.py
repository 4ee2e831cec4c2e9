"""gsjax_torch parity: kernel B's plain version (pair expansion with the
exact ellipse cull, compacted in pid order) and the (tile, depth, pid)
pair sort against gsjax, exactly.

Both packages bin the SAME home layout (gsjax's, carried over as numpy),
so every tile id, pid and segment offset must be equal. gsjax's Pallas
expansion kernel runs in interpret mode, as its own tests run it on the
CPU. The gsjax side is computed once per module."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import make_random_scene

import gsjax
import gsjax_torch as gt
from gsjax.render import binning as jbin
from gsjax.render import homesort as jhs
from gsjax.render.project import project as j_project
from gsjax_torch.render import binning as tbin
from gsjax_torch.render.homesort import HomeLayout
from gsjax_torch.render.project import ProjectedSplats

torch.set_num_threads(2)

_P_FIELDS = ("mean2d", "depth", "conic", "radius", "rgb", "opacity", "valid")
W, H = 96, 64


def to_torch(pj, lay):
    t = lambda a: torch.from_numpy(np.array(a))
    p = ProjectedSplats(**{f: t(getattr(pj, f)) for f in _P_FIELDS})
    layout = HomeLayout(
        perm=t(lay.perm), seg_starts=t(lay.seg_starts), home_x=t(lay.home_x),
        home_y=t(lay.home_y), win=t(lay.win), n_valid=t(lay.n_valid),
        n_fat_overflow=t(lay.n_fat_overflow), n_copies=t(lay.n_copies),
        tiles_x=lay.tiles_x, tiles_y=lay.tiles_y,
    )
    return p, layout


def _case(name):
    rng = np.random.default_rng(1)
    kw = {}
    if name == "fat":
        g = make_random_scene(rng, n=200, spread=1.0, z_range=(2.0, 6.0))
        g = dataclasses.replace(g, log_scales=g.log_scales + 2.0)
        kw = dict(fat_max_blocks=64, fat_cap=2048)
    elif name == "ties":
        # every splat twice: each pair has an equal-(tile, depth) partner,
        # so the pid tie rule decides the order
        g = make_random_scene(rng, n=150, spread=1.3, z_range=(3.0, 9.0))
        g = jax.tree.map(lambda a: np.concatenate([a, a]), g)
    cam = gsjax.Camera.create(fx=80.0, fy=80.0, width=W, height=H)
    cfg = gsjax.RenderConfig(backend="stream", chunk=32, **kw)
    # the repack sort (a large program to compile) once, on the fat case
    repacks = (False, True) if name == "fat" else (False,)

    @jax.jit
    def reference(g, cam):  # one compile for the whole gsjax side
        ph, lay = jhs.build_home_layout(j_project(g, cam, cfg), cam, cfg)
        bins = {
            repack: jbin.build_tile_bins(
                ph, cam, dataclasses.replace(cfg, pair_repack=repack),
                anchor="home", layout=lay,
            )
            for repack in repacks
        }
        expand = jbin.expand_home_pairs(
            ph, lay, 0, cfg.tiles_y(H), cfg.tiles_x(W), cfg
        )[:3]
        return ph, lay, bins, expand

    ph, lay, bins, expand = reference(g, cam)
    return dict(ph=ph, lay=lay, bins=bins, expand=expand,
                cfgt=gt.RenderConfig(backend="stream", chunk=32, **kw))


@pytest.fixture(scope="module")
def cases():
    return {name: _case(name) for name in ("fat", "ties")}


@pytest.mark.parametrize("name", ["fat", "ties"])
def test_expand_home_pairs_matches(cases, name):
    """Kernel B's plain version (the live candidates in pid order and
    their sort keys) against gsjax's dense expansion, compacted in numpy
    in pid order."""
    c = cases[name]
    p, layout = to_torch(c["ph"], c["lay"])
    cfg = c["cfgt"]
    pid_live, key = tbin.expand_live_pairs(p, layout, 0, cfg.tiles_y(H), cfg.tiles_x(W), cfg)
    nh, k = p.depth.shape[0], cfg.tile_span ** 2
    tj, pj, dj = (np.asarray(a) for a in c["expand"])
    tile_flat = tj.T.reshape(-1)  # index = pid
    live = np.nonzero(tile_flat != tbin.INVALID_TILE)[0]
    assert live.max() < nh * k  # the reference's pad rows emit nothing
    assert 0 < live.size < nh * k  # some candidates culled
    np.testing.assert_array_equal(pid_live.numpy(), pj.T.reshape(-1)[live])
    np.testing.assert_array_equal(pid_live.numpy(), live)
    np.testing.assert_array_equal((key >> 32).numpy(), tile_flat[live])
    want = (tile_flat[live].astype(np.int64) << 32) | (dj[live // k].astype(np.int64) + 2**31)
    np.testing.assert_array_equal(key.numpy(), want)


@pytest.mark.parametrize("name", ["fat", "ties"])
def test_build_tile_bins_matches(cases, name):
    c = cases[name]
    p, layout = to_torch(c["ph"], c["lay"])
    cam = gt.Camera.create(fx=80.0, fy=80.0, width=W, height=H, device="cpu")
    bt = tbin.build_tile_bins(p, cam, c["cfgt"], anchor="home", layout=layout)
    bj = c["bins"][False]
    n = int(bj.n_pairs)
    assert int(bt.n_pairs) == n and bt.pid_sorted.shape[0] == n
    np.testing.assert_array_equal(bt.tile_starts.numpy(), np.asarray(bj.tile_starts))
    np.testing.assert_array_equal(bt.pid_sorted.numpy(), np.asarray(bj.pid_sorted)[:n])
    assert int(bt.n_repack_overflow) == 0

    if True not in c["bins"]:
        return
    # against the repack sort: per-tile sequences equal once repack's
    # pads (sid >= NH) are dropped
    br = c["bins"][True]
    assert int(br.n_repack_overflow) == 0
    nh, k = p.depth.shape[0], c["cfgt"].tile_span ** 2
    st_t, st_r = bt.tile_starts.numpy(), np.asarray(br.tile_starts)
    pid_t, pid_r = bt.pid_sorted.numpy(), np.asarray(br.pid_sorted)
    for t in range(st_t.shape[0] - 1):
        seq = pid_r[st_r[t]:st_r[t + 1]]
        np.testing.assert_array_equal(pid_t[st_t[t]:st_t[t + 1]], seq[seq // k < nh])
