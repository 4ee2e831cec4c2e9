"""gsjax_torch parity: the reference blend path — render_oracle and the
padded-list `xla` backend (render/oracle.py, render/composite.py) —
against gsjax's on the same scene, in exact and legacy (footprint_clamp)
mode, and the port's four backends against its own oracle.

A 300-splat SH-1 scene with fat splats (so exact mode splits them and
legacy mode clamps them) at 96×64 on a generic camera pose, over a
coloured background (so the transmittance's cotangent is not zero). The
gsjax side is computed once per module: one jitted value and gradient per
configuration, with the image and aux as its auxiliary output.

Tolerances: images and transmittance maps within 1e-6 of gsjax's (the two
packages' exp / fexp and sums round alike to a few ulps), counters equal,
gradients of every Gaussians field and camera leaf within 1e-5 of the
leaf's peak (cumprod's backward differs between torch and JAX, which is
fine because each factor 1 − α ≥ 0.01); the four backends within 1e-4 of
the port's oracle (gsjax's verify recipe)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_random_scene

import gsjax
import gsjax_torch as gt

torch.set_num_threads(2)

_FIELDS = ("means", "log_scales", "quats", "sh", "opacity_logits")
_CAM_LEAVES = ("position", "quat", "fx", "fy")
W, H = 96, 64
_Q = np.array([0.99, 0.02, -0.03, 0.015]) / np.linalg.norm([0.99, 0.02, -0.03, 0.015])
CAM = dict(position=(0.05, -0.04, 0.03), quat=tuple(_Q), fx=83.0, fy=79.0, width=W,
           height=H)
KW = dict(chunk=32, tile_list_cap=256, background=(0.1, 0.2, 0.3))
# (backend, footprint_clamp) pairs whose gradients are held to gsjax's
GRAD_CASES = [("oracle", False), ("xla", False), ("xla", True)]


def _scene():
    rng = np.random.default_rng(11)
    g = make_random_scene(rng, n=300, sh_degree=1, spread=1.3, z_range=(3.0, 9.0))
    return dataclasses.replace(g, log_scales=g.log_scales + 0.9), \
        rng.uniform(0, 1, (H, W, 3)).astype(np.float32)


def _port(g, clamp=False, backend="xla", grad=True, **kw):
    """The port's render of gsjax scene g: (img, aux, {leaf: grad})."""
    gp = gt.Gaussians.from_numpy(*(np.asarray(getattr(g, f)) for f in _FIELDS),
                                 device="cpu")
    cam = gt.Camera.create(**CAM, device="cpu")
    cam = dataclasses.replace(cam, **{f: getattr(cam, f).requires_grad_()
                                      for f in _CAM_LEAVES})
    cfg = gt.RenderConfig(backend=backend, footprint_clamp=clamp, **{**KW, **kw})
    img, aux = gt.render(gp, cam, cfg, return_aux=True)
    grads = {}
    if grad:
        torch.mean((img - torch.from_numpy(_scene()[1])) ** 2).backward()
        grads = {f: getattr(gp, f).grad.numpy() for f in _FIELDS}
        grads.update({f"cam.{f}": getattr(cam, f).grad.numpy() for f in _CAM_LEAVES})
    return img.detach().numpy(), aux, grads


@pytest.fixture(scope="module")
def ref():
    """gsjax's image, aux and jax.grad (every Gaussians field and camera
    leaf) for each (backend, clamp) of GRAD_CASES."""
    g, tgt = _scene()
    cam = gsjax.Camera.create(**CAM)
    out = {"g": g}
    for backend, clamp in GRAD_CASES:
        cfg = gsjax.RenderConfig(backend=backend, footprint_clamp=clamp, **KW)

        def loss(g, cam, cfg=cfg):
            img, aux = gsjax.render(g, cam, cfg, return_aux=True)
            aux = {k: v for k, v in aux.items() if k != "projected"}
            return jnp.mean((img - tgt) ** 2), (img, aux)

        (_, (img, aux)), (gg, gc) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(g, cam)
        grads = {f: np.asarray(getattr(gg, f)) for f in _FIELDS}
        grads.update({f"cam.{f}": np.asarray(getattr(gc, f)) for f in _CAM_LEAVES})
        out[backend, clamp] = (np.asarray(img), jax.tree.map(np.asarray, aux), grads)
    return out


def test_oracle_matches_gsjax(ref):
    img_j, aux_j, _ = ref["oracle", False]
    img, aux, _ = _port(ref["g"], backend="oracle", grad=False)
    assert img.shape == (H, W, 3)
    assert np.abs(img - img_j).max() <= 1e-6
    assert np.abs(aux["transmittance"].detach().numpy() - aux_j["transmittance"]).max() <= 1e-6
    np.testing.assert_array_equal(aux["n_contrib"].numpy(), aux_j["n_contrib"])


@pytest.mark.parametrize("clamp", [False, True], ids=["exact", "legacy"])
def test_xla_matches_gsjax(ref, clamp):
    """Images, transmittance and every aux counter of gsjax's xla
    backend (in legacy mode the rect anchor over the splats, in exact
    mode the home layout and kernels A and B's plain versions)."""
    img_j, aux_j, _ = ref["xla", clamp]
    img, aux, _ = _port(ref["g"], clamp=clamp, grad=False)
    assert np.abs(img - img_j).max() <= 1e-6
    assert np.abs(aux["transmittance"].detach().numpy() - aux_j["transmittance"]).max() <= 1e-6
    keys = {k for k in aux_j if k.startswith("n_")}
    assert keys == {k for k in aux if k.startswith("n_")}
    assert {k: int(aux[k]) for k in keys} == {k: int(aux_j[k]) for k in keys}
    assert int(aux["n_pairs"]) > 0 and (int(aux["n_clamped"]) > 0) == clamp


@pytest.mark.parametrize("backend,clamp", GRAD_CASES,
                         ids=["oracle", "xla-exact", "xla-legacy"])
def test_reference_grads_match_gsjax(ref, backend, clamp):
    _, _, want = ref[backend, clamp]
    _, _, grads = _port(ref["g"], clamp=clamp, backend=backend)
    for k, a in want.items():
        b = grads[k]
        assert np.isfinite(b).all(), k
        peak = np.abs(a).max()
        assert peak > 0, k
        assert np.abs(a - b).max() <= 1e-5 * peak, (k, np.abs(a - b).max() / peak)


@pytest.mark.parametrize("clamp", [False, True], ids=["exact", "legacy"])
def test_backends_match_oracle(ref, clamp):
    """The four backends within 1e-4 of the port's oracle (under the
    clamp the oracle renders the span-clamped rects too)."""
    img_o = _port(ref["g"], clamp=clamp, backend="oracle", grad=False)[0]
    for backend in ("xla", "stream", "pallas"):
        img, aux, _ = _port(ref["g"], clamp=clamp, backend=backend, grad=False)
        assert np.abs(img - img_o).max() <= 1e-4, backend
        assert not any(int(v) for k, v in aux.items() if k.endswith("overflow")), backend


def test_tile_overflow_matches_gsjax(ref):
    """A tile list cap below the densest tile's pairs: the far pairs are
    dropped and counted (n_tile_overflow = Σ max(count − cap, 0)), as
    gsjax's one-sort path counts them. (gsjax's default repack path, a
    TPU knob the port has no use for, also counts its 128-alignment pads:
    611 here against the 599 pairs dropped; its image is the same.)"""
    cfg = gsjax.RenderConfig(backend="xla", pair_repack=False, **dict(KW, tile_list_cap=32))
    img_j, aux_j = jax.jit(lambda g, c: gsjax.render(g, c, cfg, return_aux=True))(
        ref["g"], gsjax.Camera.create(**CAM))
    img, aux, _ = _port(ref["g"], grad=False, tile_list_cap=32)
    assert int(aux["n_tile_overflow"]) == int(aux_j["n_tile_overflow"]) > 0
    assert np.abs(img - np.asarray(img_j)).max() <= 1e-6
