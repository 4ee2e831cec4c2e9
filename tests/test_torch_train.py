"""gsjax_torch parity: render gradients, the home gather's VJP, fexp's
gradient and Adam steps against gsjax's (jax.grad through its xla
backend)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gsjax_torch as gt
from gsjax.render.fastmath import fexp as j_fexp
from gsjax.render.homesort import _home_gather_bwd
from gsjax.train import default_optimizer as j_default_optimizer
from gsjax_torch import train as tt
from gsjax_torch.render import homesort as ths
from gsjax_torch.render.fastmath import fexp as t_fexp
from gsjax_torch.render.project import project

from test_torch_train_common import (CAM, H, KW, W, _FIELDS, _loss_and_grads, _segments,
                                     ref, to_torch)


@pytest.mark.parametrize("backend", ["stream", "pallas"])
@pytest.mark.parametrize("name", ["thin", "fat"])
def test_render_grads_match_gsjax_xla(ref, name, backend):
    """Both blend backends: kernel D's plain version, or kernel F's and
    the slot gather's scatter-set VJP."""
    r = ref[name]
    assert all(v == 0 for v in r["ovf"].values()), r["ovf"]
    loss, grads, aux = _loss_and_grads(r["g"], r["tgt"], backend)
    assert int(aux["n_fat_overflow"]) == 0
    assert abs(loss - r["loss"]) <= 1e-5 * r["loss"]
    for f in _FIELDS:
        a, b = np.asarray(getattr(r["grads"], f)), grads[f]
        assert np.isfinite(b).all(), f
        peak = np.abs(a).max() + 1e-12
        rel = np.abs(a - b) / peak
        # tests/test_stream.py:149-154: the bulk agrees tightly; a few
        # inclusion-threshold flips change some splats' gradients
        assert np.percentile(rel, 99) < 5e-3, (f, np.percentile(rel, 99))
        assert rel.max() < 1e-1, (f, rel.max())
    if name == "fat":
        # the splats split into copy rows: without the copy-row segment sum
        # their parents would keep only their primary block's gradient
        gp = to_torch(r["g"])
        cfg = gt.RenderConfig(chunk=32, **KW)
        p = project(gp, gt.Camera.create(**CAM, device="cpu"), cfg)
        n_ex = ths._footprint_blocks(p, cfg.tiles_x(W), cfg.tiles_y(H), cfg)[-1]
        fat = (n_ex > 0).numpy()
        assert fat.sum() > 10
        a = np.asarray(r["grads"].sh)[fat]
        assert np.abs(grads["sh"][fat]).max() > 0
        assert np.abs(grads["sh"][fat] - a).max() <= 5e-3 * np.abs(a).max()


def test_adam_steps_match_gsjax(ref):
    """Three make_step_fn steps with default_optimizer against gsjax's
    gradient + default_optimizer().update on the thin scene."""
    r = ref["thin"]
    gp = to_torch(r["g"])
    opt = tt.default_optimizer(gp)
    step = tt.make_step_fn(gt.Camera.create(**CAM, device="cpu"),
                           gt.RenderConfig(backend="stream", chunk=32, **KW), opt)
    tgt = torch.from_numpy(r["tgt"])
    losses_t = [float(step(gp, tgt)) for _ in range(3)]

    gj, tgt_j = r["g"], jnp.asarray(r["tgt"])
    optj = j_default_optimizer()
    state = optj.init(gj)
    losses_j = []
    for _ in range(3):
        (val, _), grads = ref["vg"](gj, tgt_j)
        updates, state = optj.update(grads, state, gj)
        gj = optax.apply_updates(gj, updates)
        losses_j.append(float(val))
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    g0 = r["g"]
    lrs = dict(means=1.6e-4, log_scales=5e-3, quats=1e-3, sh=2.5e-3,
               opacity_logits=5e-2)
    for f in _FIELDS:
        # the updates, in units of 3 steps at the field's learning rate:
        # Adam normalises each entry, so a gradient that differs by a
        # rounding in sign or size near zero moves its entry by up to a
        # step either way; the bulk must agree to 1%
        u_t = getattr(gp, f).detach().numpy() - np.asarray(getattr(g0, f))
        u_j = np.asarray(getattr(gj, f)) - np.asarray(getattr(g0, f))
        d = np.abs(u_t - u_j) / (3 * lrs[f])
        assert np.abs(u_j).max() > 0, f
        assert np.percentile(d, 99) < 1e-2, (f, np.percentile(d, 99))
        assert d.max() < 2.0, (f, d.max())


def test_fexp_grad_matches_gsjax():
    x = np.concatenate([np.linspace(-90.0, 0.0, 20_001, dtype=np.float32),
                        np.float32([-1e-30, -0.0])])
    xt = torch.from_numpy(x).requires_grad_()
    t_fexp(xt).backward(torch.ones_like(xt))
    gj = np.asarray(jax.vmap(jax.grad(j_fexp))(jnp.asarray(x)))
    np.testing.assert_array_max_ulp(xt.grad.numpy(), gj, 1)


@pytest.mark.parametrize("case", ["exact_small", "lognormal_200k"])
def test_home_gather_vjp_matches_gsjax(case):
    n, base, d_tail = _segments(case)
    f, c = d_tail.shape
    rng = np.random.default_rng(2)
    # a random sort permutation, truncated to NH rows: truncated entries
    # must get zero gradient
    perm_full = rng.permutation(n + f)
    nh = n + (f * 3) // 4
    inv = np.empty(n + f, np.int64)
    inv[perm_full] = np.arange(n + f)
    d_full = np.concatenate([rng.normal(size=(n, c)).astype(np.float32), d_tail])
    d = d_full[perm_full[:nh]]  # home-row cotangents

    x = torch.zeros((n, c), requires_grad=True)
    out = ths.home_gather(x, torch.zeros((f, c)), torch.from_numpy(perm_full[:nh]),
                          torch.from_numpy(inv[:n]), torch.from_numpy(inv[n:]),
                          torch.from_numpy(base))
    out.backward(torch.from_numpy(d))
    dx = x.grad.numpy()
    bwd = jax.jit(lambda inv, inv_tail, seg_base, d: _home_gather_bwd(
        (n, f, inv, inv_tail, seg_base), d)[0])  # one compile, not one per op
    dx_j = np.asarray(bwd(jnp.asarray(inv[:n], jnp.int32), jnp.asarray(inv[n:], jnp.int32),
                          jnp.asarray(base, jnp.int32), jnp.asarray(d)))

    kept = inv < nh
    dk = np.where(kept[:, None], d_full, 0.0).astype(np.float64)
    ref = np.where(kept[:n, None], dk[:n], 0.0)
    lens = np.diff(base)
    ref += np.where((lens > 0)[:, None],
                    np.add.reduceat(np.concatenate([dk[n:], np.zeros((1, c))]),
                                    np.minimum(base[:-1], f), axis=0), 0.0)
    if case == "exact_small":
        np.testing.assert_allclose(dx, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dx, dx_j, rtol=1e-5, atol=1e-5)
    else:  # tests/test_homegather_precision.py:40-43
        err = np.abs(dx - ref)
        assert err.max() < 0.02, err.max()
        assert (err / np.maximum(np.abs(ref), 1e-6)).max() < 20.0
        assert np.abs(dx - dx_j).max() < 0.02
