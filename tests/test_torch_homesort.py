"""gsjax_torch parity: the home layout and kernel A's plain version
(repeat_fat_parents) against gsjax, exactly.

Both packages lay out the SAME projected splats (gsjax's projection,
carried over as numpy), so the comparison isolates the layout: every
integer output must be equal, and the gathered attributes bit-equal.
gsjax's Pallas repeat kernel runs in interpret mode, as its own tests
run it on the CPU. The gsjax side is computed once per module."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_random_scene

import gsjax
import gsjax_torch as gt
from gsjax.render import homesort as jhs
from gsjax.render.project import project as j_project
from gsjax_torch.render import homesort as ths
from gsjax_torch.render.project import ProjectedSplats

torch.set_num_threads(2)

_P_FIELDS = ("mean2d", "depth", "conic", "radius", "rgb", "opacity", "valid")


def to_torch_p(pj):
    return ProjectedSplats(
        **{f: torch.from_numpy(np.array(getattr(pj, f))) for f in _P_FIELDS}
    )


def _cam(w=96, h=64):
    kw = dict(fx=80.0, fy=80.0, width=w, height=h)
    return gsjax.Camera.create(**kw), gt.Camera.create(**kw, device="cpu")


def _case(name):
    rng = np.random.default_rng(0)
    if name == "fat":  # tests/test_stream.py::test_stream_forward_fat_splats_exact
        g = make_random_scene(rng, n=200, spread=1.0, z_range=(2.0, 6.0))
        g = dataclasses.replace(g, log_scales=g.log_scales + 2.0)
        kw = dict(fat_max_blocks=64, fat_cap=2048)
    elif name == "overflow":  # tests/test_stream.py::test_fat_overflow_is_counted
        g = make_random_scene(rng, n=64, spread=0.8, z_range=(2.0, 5.0))
        g = dataclasses.replace(g, log_scales=g.log_scales + 2.5)
        kw = dict(fat_max_blocks=4, fat_cap=8, fat_live_cap=8)
    else:  # legacy span-budget mode
        g = make_random_scene(rng, n=300, spread=1.5, z_range=(2.0, 9.0))
        g = dataclasses.replace(g, log_scales=g.log_scales + 1.0)
        kw = dict(footprint_clamp=True)
    camj, camt = _cam()
    cfgj = gsjax.RenderConfig(backend="stream", chunk=32, **kw)
    cfgt = gt.RenderConfig(backend="stream", chunk=32, **kw)
    pj = jax.jit(j_project, static_argnums=2)(g, camj, cfgj)
    ph_j, lay_j = jax.jit(jhs.build_home_layout, static_argnums=2)(pj, camj, cfgj)
    return dict(pj=pj, ph_j=ph_j, lay_j=lay_j, camt=camt, cfgt=cfgt)


@pytest.fixture(scope="module")
def cases():
    return {name: _case(name) for name in ("fat", "overflow", "legacy")}


@pytest.mark.parametrize("name", ["fat", "overflow", "legacy"])
def test_build_home_layout_matches(cases, name):
    c = cases[name]
    lay_j = c["lay_j"]
    ph_t, lay_t = ths.build_home_layout(to_torch_p(c["pj"]), c["camt"], c["cfgt"])
    np.testing.assert_array_equal(lay_t.perm.numpy(), np.asarray(lay_j.perm))
    np.testing.assert_array_equal(lay_t.seg_starts.numpy(), np.asarray(lay_j.seg_starts))
    np.testing.assert_array_equal(lay_t.home_x.numpy(), np.asarray(lay_j.home_x))
    np.testing.assert_array_equal(lay_t.home_y.numpy(), np.asarray(lay_j.home_y))
    live = np.asarray(c["ph_j"].valid)
    np.testing.assert_array_equal(ph_t.valid.numpy(), live)
    np.testing.assert_array_equal(lay_t.win.numpy()[live], np.asarray(lay_j.win)[live])
    for f in ("n_fat_overflow", "n_copies", "n_valid"):
        assert int(getattr(lay_t, f)) == int(getattr(lay_j, f)), f
    for f in ("mean2d", "depth", "conic", "radius", "rgb", "opacity"):
        np.testing.assert_array_equal(
            getattr(ph_t, f).numpy()[live], np.asarray(getattr(c["ph_j"], f))[live], f
        )
    if name == "overflow":
        assert int(lay_t.n_fat_overflow) > 0
    elif name == "fat":
        assert int(lay_t.n_fat_overflow) == 0 and int(lay_t.n_copies) > 0


def test_repeat_fat_parents_matches(cases):
    """Kernel A's plain version vs gsjax's Pallas kernel on the same
    fat-compacted parent table."""
    c = cases["fat"]
    p = to_torch_p(c["pj"])
    cfg = c["cfgt"]
    tiles_x, tiles_y = cfg.tiles_x(96), cfg.tiles_y(64)
    span = cfg.tile_span
    g18, fb, fbe, n_copies = ths.fat_repeat_inputs(p, tiles_x, tiles_y, cfg)
    n_copies = int(n_copies)
    fat_cap, _ = ths.resolve_fat_caps(p.depth.shape[0], cfg)
    assert 0 < n_copies < fat_cap
    args = (fat_cap, tiles_x, tiles_y, span, cfg.tile_size, cfg.alpha_min)
    tail_t, keys_t = ths.repeat_fat_parents(g18, fb, fbe, n_copies, *args)
    tail_j, keys_j = jax.jit(jhs.repeat_fat_parents, static_argnums=range(4, 10))(
        jnp.asarray(g18.numpy()), jnp.asarray(fb.numpy()), jnp.asarray(fbe.numpy()),
        n_copies, *args,
    )
    keys_j = np.asarray(keys_j)
    assert keys_t.shape == (4, fat_cap) and keys_j.shape == (8, fat_cap)
    np.testing.assert_array_equal(keys_j[4:], 0.0)  # TPU padding, not kept
    np.testing.assert_array_equal(tail_t.numpy(), np.asarray(tail_j))
    np.testing.assert_array_equal(keys_t.numpy(), keys_j[:4])
    live = keys_j[0] != tiles_x * tiles_y
    assert live.any() and (~live[:n_copies]).any()  # some copy blocks culled
