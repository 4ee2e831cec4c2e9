"""Helpers of the gsjax_torch scene IO parity tests (test_torch_io*.py):
scenes, cameras and bit-level comparisons shared by the files."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsjax
import gsjax_torch as gt
from test_qply import _build_qply

torch.set_num_threads(2)

_FIELDS = ("means", "log_scales", "quats", "sh", "opacity_logits")
CAM = dict(fx=100.0, fy=100.0, width=64, height=48)  # conftest's default_camera
SHIFT = np.array([0, 0, 5.0], np.float32)  # test_qply: the codebook scene, in view


def to_torch(g):
    return gt.Gaussians.from_numpy(*(np.asarray(getattr(g, f)) for f in _FIELDS),
                                   device="cpu")


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_bits(gp, gj):
    """Every raw field bit-equal (shapes too)."""
    assert gp.n == gj.n
    for f in _FIELDS:
        np.testing.assert_array_equal(_np(getattr(gp, f)), _np(getattr(gj, f)), f)


def assert_activated(gp, gj):
    """from_activated's fields: means, quats and sh as stored (bit-equal),
    log_scales within 1 ulp, the opacity logit within one ulp of each of
    its terms plus one of their difference (test_synth_scenes_match)."""
    for f in ("means", "quats", "sh"):
        np.testing.assert_array_equal(_np(getattr(gp, f)), _np(getattr(gj, f)), f)
    np.testing.assert_array_max_ulp(_np(gp.log_scales), _np(gj.log_scales), 1)
    a, b = _np(gp.opacity_logits), _np(gj.opacity_logits)
    op = 1.0 / (1.0 + np.exp(-b.astype(np.float64)))
    ulp = lambda v: np.spacing(np.abs(v).astype(np.float32))
    assert np.all(np.abs(a - b) <= ulp(np.log(op)) + ulp(np.log1p(-op)) + ulp(b))


def shifted(g):
    return dataclasses.replace(g, means=np.asarray(g.means) * 0.2 + SHIFT)


def _cam():
    return gt.Camera.create(**CAM, device="cpu")


@pytest.fixture(scope="module")
def banded():
    """test_banded_render_matches_padded's scene: the port's BandedGaussians
    and gsjax's, the means shifted into view; gsjax's xla render and its
    jax.grad of sum(img²) through the banded scene."""
    buf, _ = _build_qply(np.random.default_rng(0), counts=(8, 8, 8, 8))
    bj = gsjax.load_ply(buf, quantized=True, banded=True)
    bj = dataclasses.replace(bj, groups=tuple(shifted(g) for g in bj.groups))
    bp = gt.BandedGaussians.from_groups([to_torch(g) for g in bj.groups])
    cam = gsjax.Camera.create(**CAM)
    cfg = gsjax.RenderConfig(backend="xla", tile_list_cap=256, chunk=32)

    def loss(b):
        img = gsjax.render(b, cam, cfg)
        return jnp.sum(img ** 2), img

    (_, img), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(bj)
    return bj, bp, np.asarray(img), grads


_EDITS = {
    "translate": lambda t, g: t.translate(g, (0.5, -0.2, 0.1)),
    "rotate": lambda t, g: t.rotate(g, np.array([0.9, 0.1, -0.2, 0.15])),
    "scale": lambda t, g: t.scale(g, 1.7),
    "scale_axes": lambda t, g: t.scale(g, (1.5, 0.5, 2.0)),
    "limit_box": lambda t, g: t.limit_box(g, -0.2, 0.2, -0.2, 0.2, 0.0, 100.0),
    "crop_box": lambda t, g: t.crop_box(g, -0.5, 0.5, -0.5, 0.5, 0.0, 100.0),
}
