"""gsjax_torch parity: camera gradients — tests/test_camera_grad.py on the
port. render() is differentiable with respect to the camera's pose
(position, quat) and intrinsics (fx, fy) on every backend; each of the
port's four backends is held to jax.grad through gsjax (the port's
oracle to gsjax's oracle, the binned backends to gsjax's xla backend) on
test_camera_grad.py's scene, camera and target.

Tolerance: each leaf's gradient within 1e-5 of its peak (the port's
binned blends read exact f32 attributes and sum in another order than
gsjax's xla blend; ~1e-6 measured), where test_camera_grad.py holds
gsjax's fast backends to its oracle at 2e-2."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_random_scene

import gsjax
import gsjax_torch as gt
from test_camera_grad import CFGS, _cam

torch.set_num_threads(2)

_FIELDS = ("means", "log_scales", "quats", "sh", "opacity_logits")
_LEAVES = ("position", "quat", "fx", "fy")
PORT_CFGS = {
    "oracle": gt.RenderConfig(backend="oracle"),
    "xla": gt.RenderConfig(backend="xla", tile_list_cap=256, chunk=32),
    "pallas": gt.RenderConfig(backend="pallas", chunk=32),
    "stream": gt.RenderConfig(backend="stream", chunk=32),
}


def _port_camera(cam, **replace):
    """The gsjax camera as a port camera whose leaves require grad."""
    c = gt.Camera.create(position=np.array(cam.position), quat=np.array(cam.quat),
                         fx=float(cam.fx), fy=float(cam.fy), width=cam.width,
                         height=cam.height, device="cpu")
    c = dataclasses.replace(c, **replace)
    return dataclasses.replace(c, **{f: getattr(c, f).detach().requires_grad_()
                                     for f in _LEAVES})


def _port_loss(g, tgt, cam, cfg):
    gp = gt.Gaussians.from_numpy(*(np.asarray(getattr(g, f)) for f in _FIELDS),
                                 device="cpu")
    return torch.mean((gt.render(gp, cam, cfg) - torch.from_numpy(tgt)) ** 2)


@pytest.fixture(scope="module")
def ref():
    """test_camera_grad.py's scene and target (its rng fixture's seed) and
    gsjax's camera gradients through its oracle and its xla backend."""
    rng = np.random.default_rng(0)
    g = make_random_scene(rng, n=250, sh_degree=1, spread=1.2, z_range=(3.0, 8.0))
    tgt = rng.uniform(0, 1, (64, 96, 3)).astype(np.float32)
    cam = _cam()
    out = {"g": g, "tgt": tgt, "cam": cam}
    for name, cfg in (("oracle", gsjax.RenderConfig(backend="oracle")),
                      ("xla", CFGS["xla"])):
        loss = lambda cam, cfg=cfg: jnp.mean((gsjax.render(g, cam, cfg) - tgt) ** 2)
        gc = jax.jit(jax.grad(loss))(cam)
        out[name] = {f: np.asarray(getattr(gc, f), np.float64).ravel() for f in _LEAVES}
    return out


@pytest.mark.parametrize("backend", list(PORT_CFGS))
def test_camera_grads_match_gsjax(ref, backend):
    want = ref["oracle" if backend == "oracle" else "xla"]
    cam = _port_camera(ref["cam"])
    _port_loss(ref["g"], ref["tgt"], cam, PORT_CFGS[backend]).backward()
    for f in _LEAVES:
        a, b = want[f], getattr(cam, f).grad.numpy().astype(np.float64).ravel()
        peak = np.abs(a).max()
        assert peak > 0, f
        assert np.abs(a - b).max() <= 1e-5 * peak, (f, np.abs(a - b).max() / peak)


def test_camera_grads_nonzero_every_leaf(ref):
    """Every camera leaf receives a nonzero cotangent on the default
    backend (a dead path, grads cut by an integer conversion, would zero
    it)."""
    cam = _port_camera(ref["cam"])
    _port_loss(ref["g"], np.zeros_like(ref["tgt"]), cam, gt.RenderConfig(chunk=32)).backward()
    for f in _LEAVES:
        assert float(getattr(cam, f).grad.abs().max()) > 0, f


def test_camera_grad_finite_difference(ref):
    """fx's gradient against a central finite difference through the
    port's xla backend (test_camera_grad.py's anchor and bound)."""
    cfg = PORT_CFGS["xla"]
    cam = _port_camera(ref["cam"])
    _port_loss(ref["g"], ref["tgt"], cam, cfg).backward()
    gfx = float(cam.fx.grad)
    eps = 0.05
    with torch.no_grad():
        lp, lm = (float(_port_loss(ref["g"], ref["tgt"], _port_camera(
            ref["cam"], fx=torch.tensor(float(ref["cam"].fx) + s)), cfg)) for s in (eps, -eps))
    fd = (lp - lm) / (2 * eps)
    assert abs(gfx - fd) < 0.15 * abs(fd) + 1e-5, (gfx, fd)
