"""Helpers of the lazy frame plan parity tests (test_torch_lazy*.py):
scenes, cameras, configurations and the gsjax side, each part a module
fixture of its own so a file computes only the parts its tests read.

tests/test_lazy.py's configuration cut to the port's test budget: n ≤ 400,
96×64 cameras, chunk 32, the fat budgets of tests/test_torch_train.py's
KW; gsjax's side keeps test_lazy.py's stream band knobs, which its plan
build also runs (band_blocks). gsjax's kernels A and B run in interpret
mode inside its plan build only; its Pallas blend is never called (the
renders it is held to come from its plain f32 `xla` backend), apart from
one lazy Adam trajectory through its LazyTrainer (its blend in interpret
mode, ~30 s, lazy_ref), which the port's reused steps are held to."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import make_random_scene

import gsjax
import gsjax_torch as gt
from gsjax.render import lazy as jl
from gsjax_torch.render import lazy as tl

torch.set_num_threads(2)

_FIELDS = tl.FIELDS
W, H = 96, 64
CAM = dict(fx=80.0, fy=80.0, width=W, height=H)
KW = dict(fat_max_blocks=64, fat_cap=2048)
CFG_T = gt.RenderConfig(backend="stream", chunk=32, **KW)
# tests/test_lazy.py's CFG with the budgets above
CFG_J = gsjax.RenderConfig(backend="stream", chunk=32, stream_band_cap=4096,
                           stream_block_tiles=3, stream_dma_chunk=256, **KW)


def to_torch(g):
    return gt.Gaussians.from_numpy(*(np.asarray(getattr(g, f)) for f in _FIELDS),
                                   device="cpu")


def _scene(name):
    """fat: footprints over many 3×3-tile blocks (tests/test_torch_train.py's
    fat scene, most splats fat); some-fat: the same draws with log_scales
    + 1, a fifth of the splats fat (the regime of test_lazy.py's Adam
    scene); thin: every footprint inside one block (test_lazy.py's
    _thin_scene)."""
    rng = np.random.default_rng(0)
    if name in ("fat", "some-fat"):
        g = make_random_scene(rng, n=300, sh_degree=1, spread=1.0, z_range=(2.0, 6.0))
        return dataclasses.replace(g, log_scales=g.log_scales + (2.0 if name == "fat" else 1.0))
    g = make_random_scene(rng, n=300, sh_degree=1, spread=1.2, z_range=(4.0, 8.0))
    return dataclasses.replace(g, log_scales=jnp.minimum(g.log_scales, jnp.log(0.02)))


def _cams():
    return gsjax.Camera.create(**CAM), gt.Camera.create(**CAM, device="cpu")


def _plan_from_gsjax(pj, n):
    """The gsjax plan's tables as a port FramePlan (the extract and fold
    tests hold the two packages' functions to the same plan)."""
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))
    return tl.FramePlan(pidx=t(pj.pidx), inv=t(pj.inv), inv_tail=t(pj.inv_tail),
                        seg_base=t(pj.seg_base), home_x=t(pj.home_x), home_y=t(pj.home_y),
                        pid=torch.zeros(0, dtype=torch.int32),
                        starts=torch.from_numpy(np.array(pj.starts)), ovf={},
                        ty0=0, tiles_x=pj.tiles_x, band_rows=pj.band_rows, n=n)


#: the lazy Adam trajectories: steps, a resort every K, learning rate
LAZY_STEPS, LAZY_K, LAZY_LR = 8, 4, 2e-3


@pytest.fixture(scope="module")
def xla_vg():
    """The jitted gsjax value and gradient of the xla render's loss
    against a target: one compile serves the fat and the thin scene (the
    same shapes)."""
    camj, _ = _cams()
    cfg_x = gsjax.RenderConfig(backend="xla", tile_list_cap=512, chunk=32, **KW)

    def loss(g, target):
        img = gsjax.render(g, camj, cfg_x)
        return jnp.mean((img - target) ** 2), img

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


@pytest.fixture(scope="module")
def fat_ref(xla_vg):
    """gsjax's frame plan of the fat scene and its xla render."""
    camj, _ = _cams()
    g = _scene("fat")
    target = jnp.full((H, W, 3), 0.25, jnp.float32)
    return dict(g=g, plan=jl.build_frame_plan(g, camj, CFG_J),
                img_xla=np.asarray(xla_vg(g, target)[0][1]))


@pytest.fixture(scope="module")
def lazy_ref():
    """gsjax's lazy Adam trajectory on the fat scene (LazyTrainer, a
    resort every LAZY_K steps)."""
    camj, _ = _cams()
    target = jnp.full((H, W, 3), 0.25, jnp.float32)
    tr = jl.LazyTrainer(_scene("fat"), CFG_J, optax.adam(LAZY_LR))
    losses = []
    for s in range(LAZY_STEPS):
        if s % LAZY_K == 0:
            tr.resort(camj)
        losses.append(float(tr.step(target, camj)))
    return dict(losses=losses, final=tr.sync())


@pytest.fixture(scope="module")
def thin_ref(xla_vg):
    """The thin scene's exact SGD trajectory (jax.grad through the xla
    backend)."""
    target = jnp.full((H, W, 3), 0.25, jnp.float32)
    g = _scene("thin")
    opt = optax.sgd(5e-2)
    ge, se, losses = g, opt.init(g), []
    for _ in range(4):
        (val, _), grads = xla_vg(ge, target)
        updates, se = opt.update(grads, se, ge)
        ge = optax.apply_updates(ge, updates)
        losses.append(float(val))
    return dict(g=g, losses=losses, final=ge)


def _moments(g, seed):
    """A pair of Adam-moment trees of g's shapes, from a seed (the second
    non-negative)."""
    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda x: rng.normal(0, 1e-3, x.shape).astype(np.float32), g)
    nu = jax.tree.map(lambda x: rng.uniform(0, 1e-6, x.shape).astype(np.float32), g)
    return mu, nu


def _flat(tree):
    return [np.asarray(getattr(tree, f)) for f in _FIELDS]
