"""gsjax_torch parity: the tile-sharded train steps over a band mesh
(gsjax_torch/parallel/render_sharded.py: make_train_step, the equalized
and the balanced steps, train.fit(mesh=...)) against the unsharded step —
tests/test_parallel.py's claims — and the first step against
jax.value_and_grad + optax.adam through gsjax's unsharded xla render."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gsjax
import gsjax_torch as gt
from gsjax_torch.core.gaussians import FIELDS
from gsjax_torch.parallel.mesh import band_rows_balanced, band_rows_for, make_mesh
from gsjax_torch.parallel.render_sharded import (make_train_step, make_train_step_balanced,
                                                 make_train_step_equalized, pad_target,
                                                 pad_target_balanced, pad_target_rows)
from gsjax_torch.render.binning import build_tile_bins
from gsjax_torch.render.project import project

from test_torch_parallel_common import KW, XLA, cams, scene, to_torch

W, H = 96, 128  # 8 tile rows
LR = 1e-3
CFG = {"stream": gt.RenderConfig(backend="stream", chunk=32, **KW),
       "xla": gt.RenderConfig(**XLA, **KW)}
OVERFLOW = ("n_pair_overflow", "n_band_overflow", "n_tile_overflow", "n_fat_overflow")


def _adam(g):
    return torch.optim.Adam(g.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)


def _params(g):
    return [getattr(g, f).detach().clone() for f in FIELDS]


def _close(a, b, atol):
    for f, x, y in zip(FIELDS, a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=atol, rtol=0, err_msg=f)


def _one_step(g_np, cam, cfg, mesh_bands, target, make=make_train_step, pad=pad_target, **kw):
    """A fresh copy of the scene, one sharded step: (loss, aux, grads,
    params after)."""
    g = to_torch(g_np)
    opt = _adam(g)
    step = make(cam, cfg, make_mesh(mesh_bands, "cpu"), opt, **kw)
    extra = kw.get("row_cuts")
    arg = mesh_bands if extra is None else max(np.diff(extra))
    loss, aux = step(g, pad(cfg, cam, target, arg))
    return (float(loss), {k: int(v) for k, v in aux.items()},
            [getattr(g, f).grad.clone() for f in FIELDS], _params(g), g, step, opt)


@pytest.fixture(scope="module")
def ref():
    """tests/test_parallel.py's train scene (150 splats, 96×128): gsjax's
    xla render as the target, the scene with its means moved by 0.01 as
    the start, and gsjax's first step from it: loss, gradients and the
    optax.adam(1e-3) update (its span-budget bins clamp nothing here, so
    they are the exact path's)."""
    camj, _ = cams(W, H)
    cfg = gsjax.RenderConfig(backend="xla", tile_list_cap=256, chunk=64, footprint_clamp=True)
    g = scene(n=150, spread=1.2)
    n_el = W * H * 3

    def loss_fn(g, t):
        img, aux = gsjax.render(g, camj, cfg, return_aux=True)
        return jnp.sum((img - t) ** 2) / n_el, aux["n_clamped"]

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    target = np.array(jax.jit(lambda g: gsjax.render(g, camj, cfg))(g))
    g0 = dataclasses.replace(g, means=g.means + 0.01)
    (loss, n_clamped), grads = vg(g0, jnp.asarray(target))
    assert int(n_clamped) == 0
    opt = optax.adam(LR)
    updates, _ = opt.update(grads, opt.init(g0), g0)
    g1 = optax.apply_updates(g0, updates)
    return dict(g0=g0, target=target, loss=float(loss),
                grads=[np.asarray(getattr(grads, f)) for f in FIELDS],
                g1=[np.asarray(getattr(g1, f)) for f in FIELDS])


@pytest.mark.parametrize("backend", ["stream", "xla"])
def test_train_step_matches_unsharded(ref, backend):
    """8 bands against 1: the loss within rel 1e-5, the parameters after
    the step within 1e-4; the first step's loss, gradients and Adam
    update against gsjax's value_and_grad + optax.adam; the loss falls
    over 4 more steps; the counters 0."""
    _, cam = cams(W, H)
    cfg = CFG[backend]
    l8, aux8, gr8, p8, g, step, _ = _one_step(ref["g0"], cam, cfg, 8, ref["target"])
    l1, _, gr1, p1, *_ = _one_step(ref["g0"], cam, cfg, 1, ref["target"])
    assert l8 == pytest.approx(l1, rel=1e-5)
    _close(p8, p1, 1e-4)
    assert l1 == pytest.approx(ref["loss"], rel=1e-5)
    for f, a, b in zip(FIELDS, gr8, ref["grads"]):
        err = float(np.abs(a.numpy() - b).max() / (np.abs(b).max() + 1e-12))
        assert err <= 1e-4, (f, err)
    _close(p8, ref["g1"], 1e-4)
    assert all(aux8[k] == 0 for k in OVERFLOW) and aux8["n_pairs"] > 0
    tgt = pad_target(cfg, cam, ref["target"], 8)
    losses = [l8] + [float(step(g, tgt)[0]) for _ in range(4)]
    assert losses[-1] < losses[0], losses


def test_train_step_uneven_split():
    """9 tile rows over 8 bands of 2 (its target padded to 16 rows)
    against 1 band (9 rows): the same loss and step, n_band_overflow 0
    (tests/test_parallel.py::test_sharded_stream_uneven_band_split); and
    an image of 8.5 tile rows over 4 bands: the whole image's loss and
    gradients."""
    w, h = 96, 144
    _, cam = cams(w, h)
    g = scene(n=200, spread=1.4, z_range=(3.0, 8.0))
    cfg = CFG["stream"]
    with torch.no_grad():
        target = gt.render(to_torch(g), cam, cfg).numpy()
    target = target + np.random.default_rng(3).normal(0, 0.02, target.shape).astype(np.float32)
    l8, aux8, _, p8, *_ = _one_step(g, cam, cfg, 8, target)
    l1, _, _, p1, *_ = _one_step(g, cam, cfg, 1, target)
    assert pad_target(cfg, cam, target, 8).shape[0] > pad_target(cfg, cam, target, 1).shape[0]
    assert l8 == pytest.approx(l1, rel=1e-5)
    _close(p8, p1, 1e-4)
    assert all(aux8[k] == 0 for k in OVERFLOW)

    # 136 rows, 8.5 tile rows: the last tile row's pixels past the image
    # are no part of the loss, so 4 bands give the whole image's loss and
    # gradients (the reference counts those pixels against its zero pad)
    _, cam = cams(w, 136)
    gw = to_torch(g)
    loss = torch.sum((gt.render(gw, cam, cfg) - torch.from_numpy(target[:136])) ** 2) / (
        w * 144 * 3)
    grads = torch.autograd.grad(loss, [getattr(gw, f) for f in FIELDS])
    l4, _, gr4, *_ = _one_step(g, cam, cfg, 4, target[:136])
    assert l4 == pytest.approx(float(loss), rel=1e-5)
    for f, a, b in zip(FIELDS, gr4, grads):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4, f


def test_equalized_cuts_match_unsharded(ref):
    """The equal-content step over cuts [0, 3, 4, 6, 8] (4 bands of 3, 1,
    2, 2 owned rows, each rendered at 3 rows with its own live): the loss
    within rel 1e-5 and the step within 1e-4 of the one-band step, every
    counter 0 (test_parallel.py::test_equalized_row_cuts_match_replicated)."""
    _, cam = cams(W, H)
    cfg = CFG["stream"]
    cuts = [0, 3, 4, 6, 8]
    leq, auxeq, _, peq, *_ = _one_step(ref["g0"], cam, cfg, 4, ref["target"],
                                       make=make_train_step_equalized, pad=pad_target_rows,
                                       row_cuts=cuts)
    l1, aux1, _, p1, *_ = _one_step(ref["g0"], cam, cfg, 1, ref["target"])
    assert pad_target_rows(cfg, cam, ref["target"], 3).shape[0] == (8 + 3) * 16
    assert leq == pytest.approx(l1, rel=1e-5)
    _close(peq, p1, 1e-4)
    assert all(auxeq[k] == 0 for k in OVERFLOW)
    assert auxeq["n_pairs"] == aux1["n_pairs"]  # each band's pairs: its owned rows'


def test_balanced_bands_match_and_balance():
    """The balanced split (device d: row groups d and d + D): at 4
    devices the loss within rel 1e-5 and the step within 1e-5 of the
    one-band contiguous step, at 8 (groups 8-15 past the image, black)
    the same loss; and on a center-heavy scene the largest device's pair
    count falls below the contiguous split's
    (test_parallel.py::test_balanced_bands_match_and_balance)."""
    _, cam = cams(W, H)
    cfg = CFG["xla"]
    g = scene(n=600, spread=0.35, z_range=(3.0, 6.0))
    with torch.no_grad():
        target = gt.render(to_torch(g), cam, cfg).numpy()
    lb, _, _, pb, *_ = _one_step(g, cam, cfg, 4, target, make=make_train_step_balanced,
                                 pad=pad_target_balanced)
    lc, _, _, pc, *_ = _one_step(g, cam, cfg, 1, target)
    assert lb == pytest.approx(lc, rel=1e-5)
    _close(pb, pc, 1e-5)
    l8, *_ = _one_step(g, cam, cfg, 8, target, make=make_train_step_balanced,
                       pad=pad_target_balanced)
    assert l8 == pytest.approx(lc, rel=1e-5)

    with torch.no_grad():
        p = project(to_torch(g), cam, cfg)
    pairs = lambda ty0, band: int(build_tile_bins(p, cam, cfg, ty0=ty0, band_rows=band).n_pairs)
    bc, gb = band_rows_for(cfg, H, 4), band_rows_balanced(cfg, H, 4)
    contig = [pairs(d * bc, bc) for d in range(4)]
    bal = [pairs(d * gb, gb) + pairs((d + 4) * gb, gb) for d in range(4)]
    assert sum(bal) == sum(contig)
    assert max(bal) < max(contig), (bal, contig)


def test_fit_with_mesh(ref):
    """train.fit(mesh=...) takes the sharded step at each view's own
    camera: over 4 bands, two views, 4 steps, its losses and parameters
    those of fit without a mesh (an image of whole tiles: the sharded
    loss is the mean), the losses falling."""
    _, cam = cams(W, H)
    cam2 = gt.Camera.create(fx=120.0, fy=120.0, width=W, height=H, position=(0.1, 0.0, 0.0),
                            device="cpu")
    cfg = CFG["stream"]
    tgts = [ref["target"], ref["target"][:, ::-1].copy()]
    runs = []
    for mesh in (make_mesh(4, "cpu"), None):
        g = to_torch(ref["g0"])
        _, losses = gt.train.fit(g, [cam, cam2], tgts, cfg, steps=4, optimizer=_adam(g),
                                 mesh=mesh)
        runs.append((losses, _params(g)))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-5)
    _close(runs[0][1], runs[1][1], 1e-4)
    assert runs[0][0][2] < runs[0][0][0]
