"""gsjax_torch parity: the span-budget (legacy) bins of
render/binning.py — the rect anchor over the projected splats and the
legacy home anchor over homesort's legacy layout — and the padded tile
lists the xla backend blends, against gsjax/render/binning.py and
gsjax/render/composite.py on the same projected splats.

A 400-splat scene with large splats (log_scales + 1, so the span clamps
many of them) spread beyond the 96×64 image (so the legacy layout's
sentinel segment holds some). Bins are integer data: pid_sorted,
tile_starts, tile_counts and the counters equal; the padded lists'
attributes bit-equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_random_scene

import gsjax
import gsjax_torch as gt
from gsjax.render.binning import build_tile_bins as j_bins
from gsjax.render.composite import build_padded_lists as j_padded
from gsjax.render.homesort import build_home_layout as j_layout
from gsjax.render.project import ProjectedSplats as JProjected
from gsjax.render.project import project as j_project
from gsjax_torch.render.binning import build_tile_bins as t_bins
from gsjax_torch.render.composite import build_padded_lists as t_padded
from gsjax_torch.render.homesort import build_home_layout as t_layout
from gsjax_torch.render.project import project as t_project

torch.set_num_threads(2)

_FIELDS = ("means", "log_scales", "quats", "sh", "opacity_logits")
CAM = dict(fx=80.0, fy=80.0, width=96, height=64)


def _projected(span=3, seed=0):
    """(gsjax p, port p, gsjax cam, port cam, gsjax cfg, port cfg) in
    legacy mode: the port's projection is the gsjax one's, field for
    field (tests/test_torch_project.py), so both bin the same splats."""
    rng = np.random.default_rng(seed)
    g = make_random_scene(rng, n=400, spread=2.5, z_range=(2.0, 9.0))
    g = dataclasses.replace(g, log_scales=g.log_scales + 1.0)
    gp = gt.Gaussians.from_numpy(*(np.asarray(getattr(g, f)) for f in _FIELDS),
                                 device="cpu")
    cj, ct = gsjax.Camera.create(**CAM), gt.Camera.create(**CAM, device="cpu")
    kw = dict(footprint_clamp=True, tile_span=span, tile_list_cap=64, chunk=32)
    cfg_j, cfg_t = gsjax.RenderConfig(**kw), gt.RenderConfig(**kw)
    pj = j_project(g, cj, cfg_j)
    with torch.no_grad():
        pt = t_project(gp, ct, cfg_t)
    # the same bits on both sides: bin the port's projection in both packages
    pj = JProjected(**{f.name: jnp.asarray(getattr(pt, f.name).numpy())
                       for f in dataclasses.fields(pt)})
    return pj, pt, cj, ct, cfg_j, cfg_t


def _assert_bins_equal(bj, bt):
    n = int(bj.n_pairs)
    assert int(bt.n_pairs) == n > 0 and bt.pid_sorted.shape[0] == n
    np.testing.assert_array_equal(bt.pid_sorted.numpy(), np.asarray(bj.pid_sorted[:n]))
    np.testing.assert_array_equal(bt.tile_starts.numpy(), np.asarray(bj.tile_starts))
    np.testing.assert_array_equal(bt.tile_counts.numpy(), np.asarray(bj.tile_counts))
    assert int(bt.n_clamped) == int(bj.n_clamped)
    assert (bt.tiles_x, bt.band_rows) == (bj.tiles_x, bj.band_rows)


@pytest.mark.parametrize("span", [3, 5])
def test_rect_bins_match_gsjax(span):
    pj, pt, cj, ct, cfg_j, cfg_t = _projected(span)
    bt = t_bins(pt, ct, cfg_t)  # the rect anchor is the default, as in gsjax
    _assert_bins_equal(j_bins(pj, cj, cfg_j), bt)
    assert int(bt.n_clamped) > 0


@pytest.mark.parametrize("span", [3, 5])
def test_legacy_home_bins_match_gsjax(span):
    """The legacy home layout (home = the mean's tile, splats beyond two
    tiles out in the sentinel segment) and its home-anchored bins: slot k
    is the pair's class, pid = home row·K + k."""
    pj, pt, cj, ct, cfg_j, cfg_t = _projected(span)
    phj, lj = j_layout(pj, cj, cfg_j)
    with torch.no_grad():
        pht, lt = t_layout(pt, ct, cfg_t)
    np.testing.assert_array_equal(lt.perm.numpy(), np.asarray(lj.perm))
    assert int(lt.n_valid) == int(lj.n_valid) < pt.depth.shape[0]  # a sentinel segment
    _assert_bins_equal(j_bins(phj, cj, cfg_j, anchor="home", layout=lj),
                       t_bins(pht, ct, cfg_t, anchor="home", layout=lt))


def test_home_anchor_equals_rect_anchor():
    """tests/test_stream.py::test_home_anchor_equals_rect_anchor on the
    port: in legacy mode both anchors enumerate the same clamped (tile,
    depth) pair set, so the tile starts and each pair's splat agree."""
    _, pt, _, ct, _, cfg_t = _projected(seed=1)
    br = t_bins(pt, ct, cfg_t, anchor="rect")
    bh = t_bins(pt, ct, cfg_t, anchor="home")
    k = cfg_t.tile_span ** 2
    assert torch.equal(br.tile_starts, bh.tile_starts)
    assert torch.equal(br.pid_sorted // k, bh.pid_sorted // k)
    assert int(br.n_pairs) > 0


def test_band_bins_match_gsjax():
    """A band of tile rows [ty0, ty0 + band_rows) (a tile-sharded
    device's share): the pairs of those rows only, band tile ids."""
    pj, pt, cj, ct, cfg_j, cfg_t = _projected()
    _assert_bins_equal(j_bins(pj, cj, cfg_j, ty0=1, band_rows=2),
                       t_bins(pt, ct, cfg_t, ty0=1, band_rows=2))


def test_unknown_anchor_raises():
    _, pt, _, ct, _, cfg_t = _projected()
    with pytest.raises(ValueError, match="unknown anchor"):
        t_bins(pt, ct, cfg_t, anchor="corner")


def test_padded_lists_match_gsjax():
    """build_padded_lists over the rect bins: the per-tile lists of
    attributes (zero on dead lanes, the far pairs past the cap dropped)
    bit-equal and the counts equal."""
    pj, pt, cj, ct, cfg_j, cfg_t = _projected()
    att_j, counts_j = j_padded(pj, j_bins(pj, cj, cfg_j), cfg_j)
    bins = t_bins(pt, ct, cfg_t)
    att, counts = t_padded(pt, bins, cfg_t)
    assert int(bins.tile_counts.max()) > cfg_t.tile_list_cap  # some tile overflows
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))
    np.testing.assert_array_equal(att.numpy(), np.asarray(att_j))
