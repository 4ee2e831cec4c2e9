"""gsjax_torch parity: SH color and projection against gsjax on the same
raw parameters (numpy bridge), f32 throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_random_scene

import gsjax
import gsjax_torch as gt
from gsjax.render import common as j_common
from gsjax.render.project import project as j_project
from gsjax.render.sh import eval_sh as j_eval_sh
from gsjax_torch.render import common as t_common
from gsjax_torch.render.project import project as t_project
from gsjax_torch.render.sh import eval_sh as t_eval_sh

torch.set_num_threads(2)

_FIELDS = ("means", "log_scales", "quats", "sh", "opacity_logits")


def to_torch(g):
    return gt.Gaussians.from_numpy(*(np.asarray(getattr(g, f)) for f in _FIELDS),
                                   device="cpu")


def cams(w=96, h=64):
    kw = dict(fx=80.0, fy=80.0, width=w, height=h)
    return [
        (gsjax.Camera.create(**kw), gt.Camera.create(**kw, device="cpu")),
        # an off-axis look_at pose: rotated view matrix, splats behind and
        # beside the camera
        (gsjax.Camera.look_at((1.5, -0.5, 2.0), (0.0, 0.2, 6.0), **kw),
         gt.Camera.look_at((1.5, -0.5, 2.0), (0.0, 0.2, 6.0), **kw, device="cpu")),
    ]


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches(rng, degree):
    k = {0: 1, 1: 4, 2: 9, 3: 16}[degree]
    sh = rng.normal(size=(257, k, 3)).astype(np.float32)
    d = rng.normal(size=(257, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    np.testing.assert_allclose(
        t_eval_sh(torch.from_numpy(sh), torch.from_numpy(d)).numpy(),
        np.asarray(j_eval_sh(jnp.asarray(sh), jnp.asarray(d))),
        rtol=1e-5, atol=1e-5,
    )


def test_rect_helpers_match(rng):
    """tile_rect, clamp_rect_to_span (both window modes) and
    gaussian_power on the same inputs: integers exactly."""
    n = 500
    mean2d = rng.uniform(-40.0, 140.0, (n, 2)).astype(np.float32)
    radius = np.ceil(rng.uniform(0.0, 60.0, n)).astype(np.float32)
    mj, mt = jnp.asarray(mean2d), torch.from_numpy(mean2d)
    rj = j_common.tile_rect(mj, jnp.asarray(radius), 6, 4, 16)
    rt = t_common.tile_rect(mt, torch.from_numpy(radius), 6, 4, 16)
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for center in (True, False):
        cj = j_common.clamp_rect_to_span(*rj, mj, 16, 3, center_window=center)
        ct = t_common.clamp_rect_to_span(*rt, mt, 16, 3, center_window=center)
        for a, b in zip(ct, cj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    conic = rng.uniform(-0.5, 1.0, (n, 3)).astype(np.float32)
    dx, dy = (rng.uniform(-9, 9, n).astype(np.float32) for _ in range(2))
    np.testing.assert_array_equal(
        t_common.gaussian_power(torch.from_numpy(conic), torch.from_numpy(dx),
                                torch.from_numpy(dy)).numpy(),
        np.asarray(j_common.gaussian_power(jnp.asarray(conic), jnp.asarray(dx),
                                           jnp.asarray(dy))),
    )


@pytest.mark.parametrize("degree", [0, 3])
def test_project_matches(rng, degree):
    gj = make_random_scene(rng, n=400, sh_degree=degree, spread=1.5,
                           z_range=(-1.0, 9.0))  # some behind the camera
    gp = to_torch(gj)
    for cj, ct in cams():
        pj = j_project(gj, cj, gsjax.RenderConfig())
        with torch.no_grad():
            pt = t_project(gp, ct, gt.RenderConfig())
        v = np.asarray(pj.valid)
        assert 0 < v.sum() < v.size  # both culled and kept splats
        np.testing.assert_array_equal(pt.valid.numpy(), v)
        np.testing.assert_array_equal(pt.radius.numpy(), np.asarray(pj.radius))
        for f in ("mean2d", "depth", "conic", "rgb", "opacity"):
            a, b = getattr(pt, f).numpy(), np.asarray(getattr(pj, f))
            np.testing.assert_allclose(a[v], b[v], rtol=1e-5, atol=1e-5, err_msg=f)
