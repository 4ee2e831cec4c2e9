"""The harness drives a whole run (the look for a card skipped: the CPU,
the port's plain versions) with the timed path broken underneath, and
`correct` comes out false: for each fault the cell can have. A step that
returns its state unchanged, the image's bottom half left out of the loss
(the mean over the rest), a frame altered where it is made; and in lazy
training a projection cached at a plan's first step, which only the steps
after it can show. (One card: no exchange between chips to leave out.)"""

from __future__ import annotations

import importlib

import pytest
import torch

from gsjax_torch.train import make_step_fn as port_make_step_fn

from gsbench.modes import serve, train_exact
from gsbench.tests import tiny

# the package's `render` function shadows its subpackage as an attribute
lazy = importlib.import_module("gsjax_torch.render.lazy")


def _loss(img, target, half: bool):
    if half:
        h = img.shape[0] // 2
        return torch.mean((img[:h] - target[:h]) ** 2)
    return torch.mean((img - target) ** 2)


def _lazy_step(half: bool, frozen: bool):
    def make(cfg):
        def step(hp, opt, target, cam, plan):
            opt.zero_grad(set_to_none=True)
            loss = _loss(lazy.lazy_render(hp, cam, cfg, plan), target, half)
            loss.backward()
            if not frozen:
                opt.step()
            return loss.detach()
        return step
    return make


def _exact_step(half: bool, frozen: bool):
    def make(cam, cfg, optimizer, on_aux=None):
        def step(g, target):
            optimizer.zero_grad(set_to_none=True)
            img, aux = train_exact.render(g, cam, cfg, return_aux=True)
            if on_aux is not None:
                on_aux(aux)
            loss = _loss(img, target, half)
            loss.backward()
            if not frozen:
                optimizer.step()
            return loss.detach()
        return step
    return make


FAULTS = [("state_unchanged", False, True), ("half_batch", True, False)]


@pytest.mark.parametrize("name,half,frozen", FAULTS)
def test_lazy_training_fault_is_not_correct(monkeypatch, name, half, frozen):
    assert tiny.rehearse("bonsai-sh3.train-lazy-orbit")["correct"] is True
    monkeypatch.setattr(lazy, "make_lazy_step", _lazy_step(half, frozen))
    out = tiny.rehearse("bonsai-sh3.train-lazy-orbit")
    assert out["correct"] is False, (name, out["checks"])


def test_lazy_cached_projection_is_not_correct(monkeypatch):
    real = lazy.lazy_cols
    cache = {}

    def cached(hp, cam, cfg):
        # the plan's first step projects; the later ones reuse its table
        # (zero gradient through it), as a stale attribute cache would
        key = hp.means.data_ptr()
        if key not in cache:
            cache.clear()
            cache[key] = real(hp, cam, cfg)
            return cache[key]
        return cache[key].detach() + 0.0 * hp.means.sum()

    monkeypatch.setattr(lazy, "lazy_cols", cached)
    out = tiny.rehearse("bonsai-sh3.train-lazy-orbit")
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("name,half,frozen", FAULTS)
def test_exact_training_fault_is_not_correct(monkeypatch, name, half, frozen):
    monkeypatch.setattr(train_exact, "make_step_fn", _exact_step(half, frozen))
    out = tiny.rehearse("garden.train-exact-shuffled")
    assert out["correct"] is False, (name, out["checks"])
    monkeypatch.setattr(train_exact, "make_step_fn", port_make_step_fn)
    assert tiny.rehearse("garden.train-exact-shuffled")["correct"] is True


def test_serving_altered_frame_is_not_correct(monkeypatch):
    real = serve.render

    def altered(g, cam, cfg, return_aux=False):
        img, aux = real(g, cam, cfg, return_aux=True)
        img = img.clone()
        img[:16, :16] += 0.05  # one tile's colour off where the frame is made
        return (img, aux) if return_aux else img

    monkeypatch.setattr(serve, "render", altered)
    out = tiny.rehearse("bonsai.serve-orbit")
    assert out["correct"] is False, out["checks"]
