"""The plain reference against the port's plain path on the CPU, on a
tiny scene: the image, the loss and every leaf's gradient of an exact
step, and the lazy trainer's steps of one plan and their fold back (whose
fat splats train as rows of their own, which the exact step's semantics
miss)."""

from __future__ import annotations

import pytest
import torch

from gsjax_torch.core.config import RenderConfig
from gsjax_torch.render.lazy import LazyTrainer
from gsjax_torch.render.pipeline import render

from gsbench import port
from gsbench.inputs import scenes
from gsbench.inputs.cameras import orbit
from gsbench.inputs.scenes import bonsai_like
from gsbench.reference import render as R
from gsbench.reference import train as T

DEV = torch.device("cpu")
CFG = RenderConfig(backend="stream", chunk=128)
FIELDS = scenes.FIELDS


def _scene(seed=2_718_281_828, n=1500):
    clean = bonsai_like.generate(n, 0, seed, 0, DEV)
    pert = scenes.perturb(clean, {"means": 2e-3, "sh": 2e-2, "opacity_logits": 5e-2}, seed, 7)
    cams = orbit.cameras({"views": 4, "sweep_deg": 30.0, "fx": 800.0, "fy": 800.0,
                          "width": 96, "height": 64})
    return clean, pert, cams


@pytest.mark.parametrize("view", [0, 3])
def test_image_matches_the_port(view):
    clean, _, cams = _scene()
    with torch.no_grad():
        img = render(port.gaussians(clean), port.camera(cams[view], DEV), CFG)
    ref = R.render(clean, cams[view])
    d = (img - ref).abs()
    assert float(d.mean()) < 1e-5 and float(d.max()) < 1e-3
    assert float(ref.mean()) > 0.05  # something was drawn


def test_exact_step_loss_and_gradients_match_the_port():
    clean, pert, cams = _scene()
    cam = port.camera(cams[1], DEV)
    with torch.no_grad():
        target = render(port.gaussians(clean), cam, CFG)
    g = port.gaussians(pert)
    loss = torch.mean((render(g, cam, CFG) - target) ** 2)
    loss.backward()
    p = {f: pert[f].clone() for f in FIELDS}
    m = {f: torch.zeros_like(p[f]) for f in FIELDS}
    v = {f: torch.zeros_like(p[f]) for f in FIELDS}
    (ref_loss,), grads = T.visit(p, m, v, 1, {f: 1e-3 for f in FIELDS}, cams[1], target,
                                 lazy=False)
    assert abs(loss.item() - ref_loss) <= 1e-5 * ref_loss
    for f in FIELDS:
        a, b = getattr(g, f).grad, grads[f]
        peak = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-3 * peak, f
        assert abs(float(a.norm()) - float(b.norm())) <= 1e-4 * float(b.norm()), f


@pytest.mark.parametrize("steps", [1, 3])
def test_lazy_step_matches_the_trainer_and_differs_from_the_exact_step(steps):
    clean, pert, cams = _scene()
    lr = {f: 1e-3 for f in FIELDS}
    cam = port.camera(cams[2], DEV)
    with torch.no_grad():
        target = render(port.gaussians(clean), cam, CFG)
    g = port.gaussians(pert)
    tr = LazyTrainer(g, CFG, torch.optim.Adam(g.parameters(), lr=1e-3))
    plan = tr.resort(cam)
    losses = [float(tr.step(target, cam)) for _ in range(steps)]
    tr.sync()
    n_live = int((plan.pidx < plan.n).sum())
    on = R.tile_rect(R.project(pert, cams[2]), 96, 64)[4]
    assert n_live > int(on.sum())  # fat splats: more rows than splats
    change = {f: getattr(g, f).detach() - pert[f] for f in FIELDS}

    def ref_change(lazy):
        out = T.train(pert, lr, [cams[2]] * (1 if lazy else steps), [target] * (1 if lazy else steps),
                      lazy=lazy, steps=steps if lazy else 1)
        return out["losses"], out["change"]

    def gap(ref):
        return max(float((change[f] - ref[f]).norm() / ref[f].norm()) for f in FIELDS)

    ref_losses, lazy_change = ref_change(lazy=True)
    assert len(ref_losses) == steps
    assert all(abs(a - b) <= 1e-4 * b for a, b in zip(losses, ref_losses)), (losses, ref_losses)
    assert gap(lazy_change) < 1e-3
    assert gap(ref_change(lazy=False)[1]) > 10 * gap(lazy_change)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0 - 2**-9 + 2**-12])
    assert R.tf32_round(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10, -3.0 - 2**-9]
