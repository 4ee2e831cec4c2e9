"""gsjax_torch parity: the training and tile-sharded example apps
(gsjax_torch/examples/train_fit.py, sharded_render.py) against gsjax, the
xla band path's exact bins (parallel/render_sharded._render_band), and
the apps' refusal to run without a card unless told.

train_fit's losses are held to gsjax's per-camera train step
(gsjax.train.make_step_fn, each view's own camera, cycled by hand with
optax.adam(2e-4)), not to gsjax.train.fit, which trains every view of
one size against the first camera. Both start from the port's demo
scene and perturbation (numpy draws), bridged to gsjax bit for bit.

The band scene: the demo scene (400 splats) at 96×128, 8 tile rows,
fx 400, where the legacy span budget clamps 86 splats. There the exact
xla band path renders the whole image's exact render; gsjax's sharded
xla renders the span-clamped rects of the rect anchor, as the port did
before (the port's rect-anchored bands reproduce it), 0.0996 off. Its
exact xla render would run its layout kernels interpreted (~11 s), so
the exact side is the port's render(xla), which tests/test_torch_
reference_blend.py holds to gsjax's."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gsjax
import gsjax_torch as gt
from gsjax.camera.orbit import OrbitCamera as j_OrbitCamera
from gsjax.parallel.mesh import make_mesh as j_make_mesh
from gsjax.parallel.render_sharded import render_sharded as j_render_sharded
from gsjax.train import make_step_fn as j_make_step_fn
from gsjax_torch.core.gaussians import FIELDS
from gsjax_torch.examples import (_common, camera_updates, file_loader, ply_converter,
                                  scene_transformations, sharded_render, simple_viewer,
                                  train_fit)
from gsjax_torch.parallel.mesh import band_rows_for, make_mesh
from gsjax_torch.parallel.render_sharded import make_train_step, pad_target, render_sharded
from gsjax_torch.render.binning import build_tile_bins
from gsjax_torch.render.composite import composite_tiles
from gsjax_torch.render.project import project

from test_torch_examples_common import (AT, EYE, FX_FIT, FX_SHARD, H, J_CFG, N, SHARD_BANDS,
                                        SHARD_H, SHARD_W, W, j_look_at, j_render)

torch.set_num_threads(2)

TOL = 2e-5  # tests/test_parallel.py's
STEPS = 10
ZERO = dict.fromkeys(_common.OVERFLOW_KEYS, 0)
CLAMP_FX = 400.0
XLA = dict(backend="xla", tile_list_cap=256)


def to_gsjax(g):
    """The port's scene → gsjax's, bit for bit."""
    return gsjax.Gaussians(**{f: jnp.asarray(getattr(g, f).detach().numpy()) for f in FIELDS})


def shard_cam(fx):
    return gt.Camera.look_at(EYE, AT, fx=fx, fy=fx, width=SHARD_W, height=SHARD_H, device="cpu")


@pytest.fixture(scope="module")
def jfit():
    """gsjax's side of train_fit: view 0's loss before training and
    STEPS steps' losses, each view's own step (make_step_fn's body,
    jitted once with the camera as an argument). Its renders are jitted
    too: XLA's fusion moves a loss, a mean, far below rtol 1e-5."""
    render = jax.jit(lambda g, cam: gsjax.render(g, cam, J_CFG, return_aux=True))

    def j_img(g, cam):
        img, aux = render(g, cam)
        assert int(aux["n_clamped"]) == 0 and int(aux["n_tile_overflow"]) == 0
        return img

    g_true = to_gsjax(_common.demo_scene(n=N, sh_degree=0, device="cpu"))
    cams = j_OrbitCamera(**train_fit.ORBIT).trajectory(4, width=W, height=H, fx=FX_FIT,
                                                        fy=FX_FIT)
    targets = [j_img(g_true, c) for c in cams]
    g = to_gsjax(train_fit.perturbed(_common.demo_scene(n=N, sh_degree=0, device="cpu")))
    loss0 = float(jnp.mean((j_img(g, cams[0]) - targets[0]) ** 2))
    opt = optax.adam(2e-4)
    step = jax.jit(lambda g, s, t, cam: j_make_step_fn(cam, J_CFG, opt).__wrapped__(g, s, t))
    state, losses = opt.init(g), []
    for s in range(STEPS):
        g, state, loss = step(g, state, targets[s % 4], cams[s % 4])
        losses.append(float(loss))
    return loss0, losses


def test_train_fit_matches_gsjax_steps(jfit, tmp_path):
    """train_fit for 10 steps (4 views at 96×64): view 0's loss before and
    every step's loss within rtol 1e-5 of gsjax's; view 0's loss falls;
    every overflow counter 0 over the targets, the evaluations and the
    steps; the two PNGs written."""
    res = train_fit.run(device="cpu", out=tmp_path, n=N, width=W, height=H, fx=FX_FIT,
                        steps=STEPS, log_every=0)
    loss0, losses = jfit
    np.testing.assert_allclose(res["loss0"], loss0, rtol=1e-5)
    np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)
    assert res["loss1"] < res["loss0"]
    assert res["overflow"] == ZERO and res["renders"] == 4 + 2 + STEPS
    assert sorted(os.listdir(tmp_path)) == ["fit_result.png", "fit_target.png"]


def test_sharded_render_matches_whole_image(tmp_path):
    """sharded_render over 8 bands of 128 rows: its frame within 2e-5 of
    the port's and gsjax's whole-image xla render of the demo scene, its
    step's loss (a black target) within 1e-6 relative of the whole
    image's mean squared error, every counter 0."""
    res = sharded_render.run(device="cpu", out=tmp_path, n=N, n_bands=SHARD_BANDS,
                             width=SHARD_W, height=SHARD_H, fx=FX_SHARD)
    g = _common.demo_scene(n=N, device="cpu")
    with torch.no_grad():
        whole = gt.render(g, shard_cam(FX_SHARD), res["cfg"])
    assert float((torch.from_numpy(res["frame"]) - whole).abs().max()) <= TOL
    jw = j_render(to_gsjax(g), j_look_at(SHARD_W, SHARD_H, FX_SHARD))
    assert float(np.abs(res["frame"] - jw).max()) <= TOL
    want = float(torch.mean(whole ** 2))
    assert abs(res["loss"] - want) <= 1e-6 * want
    assert res["overflow"] == ZERO
    assert os.listdir(tmp_path) == ["sharded.png"]


@pytest.fixture(scope="module")
def clamped():
    """The band scene, its exact whole-image xla render and that render's
    gradients of a loss against a random target (every field)."""
    g = _common.demo_scene(n=N, device="cpu")
    cam, cfg = shard_cam(CLAMP_FX), gt.RenderConfig(**XLA)
    with torch.no_grad():
        _, aux = gt.render(g, cam, dataclasses.replace(cfg, footprint_clamp=True),
                           return_aux=True)
    assert int(aux["n_clamped"]) > 0
    target = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (SHARD_H, SHARD_W, 3)).astype(np.float32))
    img, aux = gt.render(g, cam, cfg, return_aux=True)
    torch.mean((img - target) ** 2).backward()
    assert int(aux["n_fat_overflow"]) == 0 and int(aux["n_tile_overflow"]) == 0
    grads = {f: getattr(g, f).grad.clone() for f in FIELDS}
    return dict(g=g, cam=cam, cfg=cfg, img=img.detach(), target=target, grads=grads)


@pytest.mark.parametrize("n_bands", [2, 4, 8])
def test_sharded_xla_bins_exactly(clamped, n_bands):
    """On the band scene the sharded xla render over 2, 4 and 8 bands is
    the exact render within 2e-5, with every counter of its bands 0, and
    a sharded step's gradients are the whole image's within 1e-5 of each
    leaf's peak; under footprint_clamp=True it renders the whole image's
    legacy render as before."""
    g, cam, cfg = clamped["g"], clamped["cam"], clamped["cfg"]
    mesh = make_mesh(n_bands, "cpu")
    with torch.no_grad():
        img, aux = render_sharded(g, cam, cfg, mesh, return_aux=True)
    assert float((img[:SHARD_H, :SHARD_W] - clamped["img"]).abs().max()) <= TOL
    assert all(int(aux[k]) == 0 for k in ZERO if k in aux)
    step = make_train_step(cam, cfg, mesh, torch.optim.SGD(g.parameters(), lr=0.0))
    step(g, pad_target(cfg, cam, clamped["target"], n_bands))
    for f in FIELDS:
        ref = clamped["grads"][f]
        d = float((getattr(g, f).grad - ref).abs().max() / ref.abs().max())
        assert d <= 1e-5, (f, d)
    legacy = dataclasses.replace(cfg, footprint_clamp=True)
    with torch.no_grad():
        s = render_sharded(g, cam, legacy, mesh)[:SHARD_H, :SHARD_W]
        assert float((s - gt.render(g, cam, legacy)).abs().max()) <= TOL


def _rect_bands(g, cam, cfg, n_bands):
    """Each band binned by its span-clamped rects (the rect anchor, the
    legacy span budget whatever footprint_clamp says) and blended: the
    reference's sharded xla band body."""
    band = band_rows_for(cfg, cam.height, n_bands)
    p = project(g, cam, cfg)
    return torch.cat([composite_tiles(p, build_tile_bins(p, cam, cfg, ty0=d * band,
                                                         band_rows=band), cam, cfg)[0]
                      for d in range(n_bands)])


def test_reference_sharded_xla_clamps(clamped):
    """The reference fault the port does not copy: gsjax's render_sharded
    (xla, exact mode) over 8 devices bins each band's span-clamped rects
    (gsjax/parallel/render_sharded.py:111-113), so it is the port's
    rect-anchored bands within 2e-5 and more than 1e-2 off the exact
    render; its whole-image legacy render (footprint_clamp=True, the
    centred clamp) is another image again."""
    g, cam, cfg = clamped["g"], clamped["cam"], clamped["cfg"]
    gj, camj = to_gsjax(g), j_look_at(SHARD_W, SHARD_H, CLAMP_FX)
    jcfg = gsjax.RenderConfig(**XLA)
    mesh = j_make_mesh(SHARD_BANDS)
    js = np.asarray(jax.jit(lambda g: j_render_sharded(g, camj, jcfg, mesh))(gj))
    with torch.no_grad():
        rect = _rect_bands(g, cam, cfg, SHARD_BANDS)
    assert float(np.abs(js - rect.numpy()).max()) <= TOL
    assert float(np.abs(js[:SHARD_H, :SHARD_W] - clamped["img"].numpy()).max()) > 1e-2
    legacy = dataclasses.replace(jcfg, footprint_clamp=True)
    jl = np.asarray(jax.jit(lambda g: gsjax.render(g, camj, legacy))(gj))
    assert float(np.abs(js[:SHARD_H, :SHARD_W] - jl).max()) > 1e-3


APPS = (simple_viewer, file_loader, ply_converter, scene_transformations, camera_updates,
        train_fit, sharded_render)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the apps would run on the card")
def test_apps_raise_without_a_card(tmp_path):
    """Without a card an app run with no --device raises (its scene is
    made on cuda; nothing falls back to the CPU) before it writes
    anything: main([]) leaves the default output directory as it was,
    and main(["--out", DIR]) makes no DIR."""
    before = sorted(os.listdir(_common.OUT)) if os.path.isdir(_common.OUT) else None
    for app in APPS:
        with pytest.raises((AssertionError, RuntimeError)):
            app.main([])
        out = tmp_path / app.__name__.rsplit(".", 1)[1]
        with pytest.raises((AssertionError, RuntimeError)):
            app.main(["--out", str(out)])
        assert not out.exists(), app.__name__
    after = sorted(os.listdir(_common.OUT)) if os.path.isdir(_common.OUT) else None
    assert after == before
