"""gsjax_torch parity: the whole serving slice, render(backend="stream")
and render(backend="pallas") (the flat slot-stream blend), and the
headless viewer, against gsjax.

The port's blend reads exact f32 attributes, so it is held to gsjax's
plain f32 reference blend (backend "xla") at the bound
tests/test_stream.py uses for gsjax's own exact-table stream: only the
transmittance products' accumulation order differs. Fat-splat scenes are
held to gsjax's unclamped oracle with tests/test_stream.py's bounds. The
gsjax side is computed once per module."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import make_random_scene

import gsjax
import gsjax_torch as gt
from gsjax import OrbitCamera
from gsjax_torch import kernels

torch.set_num_threads(2)

_FIELDS = ("means", "log_scales", "quats", "sh", "opacity_logits")
W, H = 96, 64
ORBIT_CAM = dict(fx=80.0, fy=80.0, width=W, height=H)


def to_torch(g):
    return gt.Gaussians.from_numpy(*(np.asarray(getattr(g, f)) for f in _FIELDS),
                                   device="cpu")


def _cams(w=W, h=H):
    kw = dict(fx=80.0, fy=80.0, width=w, height=h)
    return gsjax.Camera.create(**kw), gt.Camera.create(**kw, device="cpu")


def _megasplat_scene(rng):
    """tests/test_stream.py::test_fat_splat_1024px_reach: one splat whose
    footprint covers the whole image."""
    n = 32
    means = np.stack(
        [rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(4.0, 8.0, n)],
        axis=-1,
    )
    scales = np.full((n, 3), 0.04)
    scales[0] = 2.5
    means[0] = (0.0, 0.0, 4.0)
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    sh = rng.normal(size=(n, 1, 3)) * 0.3 + 0.4
    return gsjax.Gaussians.from_activated(
        means=means, scales=scales, quats=quats,
        opacities=rng.uniform(0.3, 0.8, n), sh=sh,
    )


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(0)
    camj, _ = _cams()
    out = {}
    # one compile of gsjax's plain f32 render serves the fixed camera and
    # the orbit (same scene, same image size)
    xla = jax.jit(
        lambda g, c: gsjax.render(
            g, c, gsjax.RenderConfig(backend="xla", tile_list_cap=256, chunk=32),
            return_aux=True,
        )
    )
    g = make_random_scene(rng, n=400, sh_degree=1, spread=1.3, z_range=(3.0, 9.0))
    img, aux = xla(g, camj)
    out["thin"] = (g, np.asarray(img), np.asarray(aux["transmittance"]))
    # gsjax.viewer.render_orbit = OrbitCamera(...).trajectory + render
    orbit = OrbitCamera(radius=5.0, target=(0.0, 0.0, 6.0)).trajectory(2, **ORBIT_CAM)
    out["orbit"] = np.stack([np.asarray(xla(g, c)[0]) for c in orbit])

    g = make_random_scene(rng, n=200, spread=1.0, z_range=(2.0, 6.0))
    g = dataclasses.replace(g, log_scales=g.log_scales + 2.0)
    oracle = jax.jit(lambda g, c: gsjax.render(g, c, gsjax.RenderConfig(backend="oracle")))
    out["fat"] = (g, np.asarray(oracle(g, camj)))
    g = _megasplat_scene(rng)
    out["mega"] = (g, np.asarray(oracle(g, camj)))
    return out


@pytest.mark.parametrize("backend", ["stream", "pallas"])
def test_render_matches_gsjax_xla(ref, backend):
    """Both blend backends (the flat one's reference semantics are gsjax's
    xla blend: gsjax/render/composite.py:19-20, tests/test_pallas.py)."""
    g, img_j, T_j = ref["thin"]
    _, camt = _cams()
    kernels.reset_launches()
    with torch.no_grad():
        img, aux = gt.render(to_torch(g), camt, gt.RenderConfig(backend=backend, chunk=32),
                             return_aux=True)
    assert img.shape == (H, W, 3)
    # only the transmittance products' accumulation order differs
    assert np.abs(img.numpy() - img_j).max() < 2e-5
    assert np.abs(aux["transmittance"].numpy() - T_j).max() < 2e-5
    assert set(aux) == {"transmittance", "n_clamped", "n_pairs", "n_tile_overflow",
                        "n_pair_overflow", "n_band_overflow", "n_fat_overflow",
                        "projected"}
    for k in ("n_tile_overflow", "n_pair_overflow", "n_band_overflow", "n_fat_overflow"):
        assert int(aux[k]) == 0, k
    assert int(aux["n_pairs"]) > 0
    # CPU tensors take the kernels' plain versions: no kernel launched
    assert kernels.LAUNCHES and not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


@pytest.mark.parametrize("backend", ["stream", "pallas"])
@pytest.mark.parametrize("name", ["fat", "mega"])
def test_fat_splats_match_gsjax_oracle(ref, name, backend):
    """Footprints spanning many tiles (and one covering the whole image,
    the reference's 1024-px reach) render the UNCLAMPED rect."""
    g, img_o = ref[name]
    _, camt = _cams()
    kw = dict(fat_max_blocks=64, fat_cap=2048) if name == "fat" else \
        dict(fat_max_blocks=256, fat_cap=512)
    with torch.no_grad():
        img, aux = gt.render(to_torch(g), camt,
                             gt.RenderConfig(backend=backend, chunk=32, **kw),
                             return_aux=True)
    assert int(aux["n_fat_overflow"]) == 0
    d = np.abs(img.numpy() - img_o)
    if name == "fat":  # tests/test_stream.py:81-82
        assert np.percentile(d, 99.5) < 5e-4, np.percentile(d, 99.5)
        assert d.max() < 1e-2, d.max()
    else:  # tests/test_stream.py:120
        assert d.max() < 5e-3, d.max()


def test_render_orbit_matches_gsjax(ref, tmp_path):
    g = ref["thin"][0]
    frames_j = ref["orbit"]
    frames = gt.render_orbit(to_torch(g), n_frames=2, radius=5.0,
                             target=(0.0, 0.0, 6.0), cfg=gt.RenderConfig(chunk=32),
                             out_dir=str(tmp_path), **ORBIT_CAM, device="cpu")
    assert frames.shape == frames_j.shape == (2, H, W, 3)
    assert np.abs(frames - frames_j).max() < 2e-5
    assert np.abs(frames[0] - frames[1]).max() > 1e-2  # the camera moved
    assert sorted(p.name for p in tmp_path.iterdir()) == ["frame_0000.png",
                                                          "frame_0001.png"]


def test_stream_rejects_other_spans(ref):
    g, _, _ = ref["thin"]
    _, camt = _cams()
    with pytest.raises(ValueError, match="tile_span"):
        gt.render(to_torch(g), camt, gt.RenderConfig(tile_span=5, chunk=32))
