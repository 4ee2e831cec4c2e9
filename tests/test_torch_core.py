"""gsjax_torch parity: configuration, scene synthesis, cameras, fexp, and
the package's independence from JAX.

Inputs are made with numpy from a seed; gsjax's raw parameters cross into
the port through the numpy bridge (Gaussians.from_numpy), so both
packages compute from the same bits."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsjax
import gsjax_torch as gt
from gsjax.bench import synth as jsynth
from gsjax.core.gaussians import quat_to_rotmat as j_quat_to_rotmat
from gsjax.render.fastmath import fexp as j_fexp
from gsjax_torch.bench import synth as tsynth
from gsjax_torch.core.gaussians import quat_to_rotmat as t_quat_to_rotmat
from gsjax_torch.render.fastmath import fexp as t_fexp

torch.set_num_threads(2)

_FIELDS = ("means", "log_scales", "quats", "sh", "opacity_logits")


def test_render_config_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(gsjax.RenderConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(gt.RenderConfig)]
    assert tf == jf
    cfg = gt.RenderConfig()
    assert cfg.tiles_x(1920) == 120 and cfg.tiles_y(1080) == 68


@pytest.mark.parametrize(
    "scene,kw",
    [("bonsai_like", dict(n=3000, seed=3, sh_degree=1)),
     ("garden_like", dict(n=2000, seed=1, sh_degree=2))],
)
def test_synth_scenes_match(scene, kw):
    gj = getattr(jsynth, scene)(**kw)
    gp = getattr(tsynth, scene)(**kw, device="cpu")
    for f in ("means", "quats", "sh"):
        # the same numpy draws, stored as they are
        np.testing.assert_array_equal(
            getattr(gp, f).detach().numpy(), np.asarray(getattr(gj, f)), f
        )
    # from_activated's log / log1p: torch vs jnp, within 1 ulp
    np.testing.assert_array_max_ulp(
        gp.log_scales.detach().numpy(), np.asarray(gj.log_scales), 1
    )
    # the logit log(op) - log1p(-op) cancels near op = 0.5: bound it by
    # one ulp of EACH term plus the rounding of their difference, not by
    # an ulp of the (tiny) difference
    a, b = gp.opacity_logits.detach().numpy(), np.asarray(gj.opacity_logits)
    op = 1.0 / (1.0 + np.exp(-b.astype(np.float64)))
    ulp = lambda v: np.spacing(np.abs(v).astype(np.float32))
    assert np.all(np.abs(a - b) <= ulp(np.log(op)) + ulp(np.log1p(-op)) + ulp(b))


def test_numpy_bridge_is_bit_exact(rng):
    gj = jsynth.bonsai_like(n=500, seed=5)
    gp = gt.Gaussians.from_numpy(*(np.asarray(getattr(gj, f)) for f in _FIELDS),
                                 device="cpu")
    for f in _FIELDS:
        np.testing.assert_array_equal(
            getattr(gp, f).detach().numpy(), np.asarray(getattr(gj, f))
        )
    assert isinstance(gp, torch.nn.Module)
    assert [n for n, _ in gp.named_parameters()] == list(_FIELDS)
    np.testing.assert_allclose(
        gp.rotation_matrices().detach().numpy(),
        np.asarray(gj.rotation_matrices()), atol=1e-6,
    )


@pytest.mark.parametrize(
    "pos,target",
    [((0.0, -0.6, -4.0), (0.0, 0.0, 0.0)),
     ((3.0, 1.0, 2.0), (0.5, -0.2, 0.1)),
     ((0.0, 5.0, 0.0), (0.0, 0.0, 0.0))],  # looking straight down the up axis
)
def test_camera_view_matrix_matches(pos, target):
    kw = dict(fx=900.0, fy=800.0, width=96, height=64)
    cj = gsjax.Camera.look_at(pos, target, **kw)
    ct = gt.Camera.look_at(pos, target, **kw, device="cpu")
    np.testing.assert_array_equal(ct.quat.numpy(), np.asarray(cj.quat))
    np.testing.assert_allclose(
        ct.view_matrix().numpy(), np.asarray(cj.view_matrix()), atol=1e-6
    )
    for a, b in zip(ct.tan_half_fov(), cj.tan_half_fov()):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-7)


def test_quat_to_rotmat_matches(rng):
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        t_quat_to_rotmat(torch.from_numpy(q)).numpy(),
        np.asarray(j_quat_to_rotmat(jnp.asarray(q))),
        atol=1e-7,
    )


def test_fexp_within_one_ulp():
    x = np.linspace(-87.0, 0.0, 200_001, dtype=np.float32)
    x = np.concatenate([x, np.float32([-1e-30, -0.0, -88.0, -200.0])])
    np.testing.assert_array_max_ulp(
        t_fexp(torch.from_numpy(x)).numpy(), np.asarray(j_fexp(jnp.asarray(x))), 1
    )


def test_package_imports_no_jax():
    """Importing every gsjax_torch module leaves no jax / gsjax module
    loaded (fresh interpreter: the test process itself has jax)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import importlib, pkgutil, sys\n"
        "import gsjax_torch\n"
        "for m in pkgutil.walk_packages(gsjax_torch.__path__, 'gsjax_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'gsjax'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_unported_paths_raise(rng):
    gp = tsynth.bonsai_like(n=200, seed=0, device="cpu")
    cam = gt.Camera.create(position=(0.0, 0.0, -4.0), fx=60.0, fy=60.0,
                           width=32, height=32, device="cpu")
    for backend in ("oracle", "xla"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            gt.render(gp, cam, gt.RenderConfig(backend=backend))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gt.render_trajectory(gp, [cam], fade_in=True)
    # the stream and flat ("pallas") backends' backwards are ported: a
    # gradient reaches every field
    for backend in ("stream", "pallas"):
        gp.zero_grad(set_to_none=True)
        img = gt.render(gp, cam, gt.RenderConfig(backend=backend, chunk=32))
        img.sum().backward()
        for name, p in gp.named_parameters():
            assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
        assert float(gp.opacity_logits.grad.abs().max()) > 0, backend
