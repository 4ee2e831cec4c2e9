"""Helpers of the gsjax_torch training parity tests (test_torch_train*.py):
scenes, the gsjax reference fixture and loss helpers."""

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
W, H = 96, 64
CAM = dict(fx=80.0, fy=80.0, width=W, height=H)


def to_torch(g):
    return gt.Gaussians.from_numpy(*(np.asarray(getattr(g, f)) for f in _FIELDS),
                                   device="cpu")


# the fat scene's budgets (tests/test_stream.py's fat-splat cases); on the
# thin scene, whose footprints span one 3×3-tile block, they change nothing
KW = dict(fat_max_blocks=64, fat_cap=2048)


def _scene(name):
    """thin: test_stream_grads_match_xla's scene; fat: the same generator
    with footprints over many 3×3-tile blocks (log_scales + 2)."""
    rng = np.random.default_rng(0)
    if name == "thin":
        g = make_random_scene(rng, n=300, sh_degree=1, spread=1.2, z_range=(3.0, 8.0))
    else:
        g = make_random_scene(rng, n=300, sh_degree=1, spread=1.0, z_range=(2.0, 6.0))
        g = dataclasses.replace(g, log_scales=g.log_scales + 2.0)
    tgt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    return g, tgt


@pytest.fixture(scope="module")
def ref():
    """The jitted gsjax value-and-grad of the image loss ("vg") and, per
    scene, (g, target, loss and gradient at g, gsjax's aux counters)."""
    camj = gsjax.Camera.create(**CAM)
    cfg = gsjax.RenderConfig(backend="xla", tile_list_cap=512, chunk=32, **KW)

    def loss(g, t):
        img, aux = gsjax.render(g, camj, cfg, return_aux=True)
        ovf = {k: aux[k] for k in ("n_tile_overflow", "n_fat_overflow")}
        return jnp.mean((img - t) ** 2), ovf

    out = {"vg": jax.jit(jax.value_and_grad(loss, has_aux=True))}
    for name in ("thin", "fat"):
        g, tgt = _scene(name)
        (val, ovf), grads = out["vg"](g, jnp.asarray(tgt))
        out[name] = dict(g=g, tgt=tgt, loss=float(val), grads=grads,
                         ovf={k: int(v) for k, v in ovf.items()})
    return out


def _loss_and_grads(g, tgt, backend):
    gp = to_torch(g)
    cam = gt.Camera.create(**CAM, device="cpu")
    img, aux = gt.render(gp, cam, gt.RenderConfig(backend=backend, chunk=32, **KW),
                         return_aux=True)
    loss = torch.mean((img - torch.from_numpy(tgt)) ** 2)
    loss.backward()
    return loss.item(), {f: getattr(gp, f).grad.numpy() for f in _FIELDS}, aux


def _segments(case):
    """tests/test_homegather_precision.py's inputs: (n, seg_base, d_tail)."""
    if case == "exact_small":
        rng = np.random.default_rng(1)
        n, c = 500, 2
        lens = rng.integers(0, 7, n)
        d_tail = rng.normal(size=(int(lens.sum()), c)).astype(np.float32)
    else:  # adversarial lognormal magnitudes, ~200k copy rows
        rng = np.random.default_rng(0)
        n = 60_000
        lens = np.minimum(rng.poisson(200_000 / n, n), 255)
        f = int(lens.sum())
        d_tail = rng.normal(size=(f, 3)).astype(np.float32) * rng.lognormal(
            0, 2, size=(f, 1)).astype(np.float32)
    return n, np.concatenate([[0], np.cumsum(lens)]), d_tail
