"""gsjax_torch parity: render_sharded over a band mesh
(gsjax_torch/parallel/render_sharded.py) against gsjax's UNSHARDED xla
render of the same scene — the stream path (prefilter, layout, slice,
band bins, kernels C and D's plain versions) and the xla path, at 1, 2,
4 and 8 bands, an odd height (the pad rows) and 9 tile rows over 8
bands (the uneven split); and a band's drops counted in
n_band_overflow."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import gsjax
import gsjax_torch as gt
from gsjax_torch.parallel.mesh import make_mesh, padded_height
from gsjax_torch.parallel.render_sharded import (_render_band, make_train_step, pad_target,
                                                 render_sharded)
from gsjax_torch.render import homesort as th
from gsjax_torch.render.project import project

from test_torch_parallel_common import KW, XLA, cams, scene, to_torch

TOL = 2e-5  # tests/test_parallel.py's
# (width, height, scene kwargs): tests/test_parallel.py's stream scene at
# 8 tile rows, its odd-height case, and its uneven split (9 rows)
CASES = {
    "even": (96, 128, dict(n=200, spread=1.2, z_range=(3.0, 8.0))),
    "odd-height": (80, 90, dict(n=100, spread=1.0)),
    "uneven": (96, 144, dict(n=200, spread=1.4, z_range=(3.0, 8.0))),
}
BACKENDS = {"stream": gt.RenderConfig(backend="stream", chunk=32, **KW),
            "xla": gt.RenderConfig(**XLA, **KW)}


@pytest.fixture(scope="module")
def ref():
    """gsjax's unsharded xla render of each case (jitted). Its span-budget
    bins (footprint_clamp=True: no interpret-mode layout kernels, ~1 s
    against ~8 s a shape) clamp no splat of these scenes (n_clamped 0),
    so they are the exact bins' pair set and image."""
    cfg = gsjax.RenderConfig(backend="xla", tile_list_cap=128, chunk=64, footprint_clamp=True)
    out = {}
    for name, (w, h, kw) in CASES.items():
        camj, _ = cams(w, h)
        g = scene(**kw)
        img, aux = jax.jit(lambda g: gsjax.render(g, camj, cfg, return_aux=True))(g)
        assert int(aux["n_tile_overflow"]) == 0 and int(aux["n_clamped"]) == 0
        out[name] = dict(g=g, img=np.array(img))
    return out


def _check(ref, name, n_bands):
    w, h, _ = CASES[name]
    _, camt = cams(w, h)
    g = to_torch(ref[name]["g"])
    imgs = {}
    with torch.no_grad():
        for backend, cfg in BACKENDS.items():
            img = render_sharded(g, camt, cfg, make_mesh(n_bands, "cpu"))
            assert img.shape == (padded_height(cfg, h, n_bands), -(-w // 16) * 16, 3)
            d = float((img[:h, :w] - torch.from_numpy(ref[name]["img"])).abs().max())
            assert d <= TOL, (backend, n_bands, d)
            assert not img[h:].any() and not img[:, w:].any()  # the pad is black
            imgs[backend] = img
        # "auto" and "pallas" run the stream path on every device
        for alias in ("auto", "pallas"):
            cfg = dataclasses.replace(BACKENDS["stream"], backend=alias)
            assert torch.equal(render_sharded(g, camt, cfg, make_mesh(n_bands, "cpu")),
                               imgs["stream"])


@pytest.mark.parametrize("n_bands", [1, 2, 4, 8])
def test_render_sharded_matches_unsharded(ref, n_bands):
    """8 tile rows over 1, 2, 4 and 8 bands, stream and xla, within 2e-5
    of gsjax's unsharded xla render."""
    _check(ref, "even", n_bands)


def test_render_sharded_odd_height(ref):
    """90 rows (6 tile rows, the last one partly image) over 8 bands of 1:
    bands 6 and 7 lie past the image and render black."""
    _check(ref, "odd-height", 8)


def test_render_sharded_uneven_split(ref):
    """9 tile rows over 8 bands of 2 (tests/test_parallel.py::
    test_sharded_stream_uneven_band_split): band 4 renders row 8 from a
    slice whose halo runs past the image; bands 5-7 are past it."""
    _check(ref, "uneven", 8)
    _check(ref, "uneven", 4)


def test_render_band_counts_its_drops(ref):
    """A band whose prefilter and slice caps are too small: the splats and
    home rows dropped are counted in n_band_overflow (the band functions'
    own counts, summed), never silent."""
    w, h, _ = CASES["uneven"]
    _, camt = cams(w, h)
    g = to_torch(ref["uneven"]["g"])
    ty0, band, cap_n, cap = 2, 3, 100, 16
    cfg = dataclasses.replace(BACKENDS["stream"], shard_prefilter_cap=cap_n,
                              shard_slice_cap=cap)
    with torch.no_grad():
        _, aux = _render_band(g, camt, cfg, ty0, band)
        p = project(g, camt, cfg)
        pb, n_pref = th.band_prefilter(p, ty0, band, 9, 6, cap_n, cfg)
        ph, lay = th.build_home_layout(pb, camt, cfg)
        _, _, n_sliced = th.slice_band_rows(ph, lay, ty0, band, cap)
    assert int(n_pref) > 0 and int(n_sliced) > 0
    assert int(aux["n_band_overflow"]) == int(n_pref) + int(n_sliced)


def test_mesh_checks_the_scene_device(ref):
    """A band mesh moves nothing between devices: render_sharded and a
    train step on a mesh of another device than the scene's raise
    before they render."""
    w, h, _ = CASES["even"]
    _, camt = cams(w, h)
    g = to_torch(ref["even"]["g"])
    cfg = BACKENDS["xla"]
    mesh = make_mesh(2, "cuda")
    assert mesh.device == torch.device("cuda")
    with pytest.raises(ValueError, match="the mesh on cuda"):
        render_sharded(g, camt, cfg, mesh)
    step = make_train_step(camt, cfg, mesh, torch.optim.Adam(g.parameters(), 1e-3))
    with pytest.raises(ValueError, match="the mesh on cuda"):
        step(g, pad_target(cfg, camt, np.zeros((h, w, 3), np.float32), 2, device="cpu"))
    make_mesh(2, "cpu").check(g)
