"""gsjax_torch parity: lazy training trajectories against gsjax's (the
exact SGD trajectory, the LazyTrainer's reused Adam steps), their drift
from the exact path, the copy slots' parents and the bench runner's lazy
modes."""

import json

import numpy as np
import pytest
import torch

import gsjax_torch as gt
from gsjax_torch import train as tt
from gsjax_torch.bench import run as trun
from gsjax_torch.render import lazy as tl

# module fixtures come in with the helpers (xla_vg: the one the others request)
from test_torch_lazy_common import (CFG_T, H, LAZY_K, LAZY_LR, LAZY_STEPS, W, _FIELDS,
                                    _cams, _scene, lazy_ref, thin_ref, to_torch, xla_vg)


def test_lazy_sgd_thin_matches_gsjax_exact(thin_ref):
    """A resort before each of 4 SGD steps on the thin scene: the lazy
    trajectory's losses and final parameters equal gsjax's exact xla
    trajectory (tests/test_lazy.py:81-117's bounds: the fold-back of one
    row per splat under a gradient-linear optimizer is exact)."""
    _, camt = _cams()
    g = to_torch(thin_ref["g"])
    tr = tl.LazyTrainer(g, CFG_T, torch.optim.SGD(g.parameters(), lr=5e-2), reduce="sum")
    target = torch.full((H, W, 3), 0.25)
    losses = []
    for _ in range(4):
        plan = tr.resort(camt)
        assert (plan.pidx[plan.pidx < plan.n].bincount() == 1).any()
        assert (plan.pidx[plan.pidx < plan.n].bincount() <= 1).all()  # no copy rows
        losses.append(float(tr.step(target, camt)))
    gl = tr.sync()
    assert gl is g
    np.testing.assert_allclose(losses, thin_ref["losses"], rtol=1e-5)
    for f in _FIELDS:
        np.testing.assert_allclose(getattr(g, f).detach().numpy(),
                                   np.asarray(getattr(thin_ref["final"], f)), atol=1e-5,
                                   err_msg=f)


def test_lazy_adam_reuse_matches_gsjax(lazy_ref):
    """The reused steps against gsjax: Adam with a resort every LAZY_K
    steps on the fat scene (most splats fat, so most rows take their own
    Adam step between resorts and the fold averages them), the port's
    LazyTrainer against gsjax's on the same scene and camera. Losses and
    folded parameters within 1e-5: the steps that reuse a stale layout
    are the reference's, not only the first step after a resort."""
    _, camt = _cams()
    g = to_torch(_scene("fat"))
    opt = torch.optim.Adam(g.parameters(), lr=LAZY_LR)
    tr = tl.LazyTrainer(g, CFG_T, opt)
    target = torch.full((H, W, 3), 0.25)
    losses = []
    for s in range(LAZY_STEPS):
        if s % LAZY_K == 0:
            plan = tr.resort(camt)
            assert int((plan.pidx[plan.pidx < plan.n].bincount() > 1).sum()) > 100
        losses.append(float(tr.step(target, camt)))
    tr.sync()
    want = lazy_ref
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    for f in _FIELDS:
        np.testing.assert_allclose(getattr(g, f).detach().numpy(),
                                   np.asarray(getattr(want["final"], f)), atol=1e-5,
                                   err_msg=f)


def test_lazy_adam_reuse_drift_bounded():
    """K = 4 layout reuse with Adam on a scene with fat splats against the
    port's exact trajectory (tests/test_lazy.py:120-169's bounds): the
    same first loss, the loss falls, per-step drift under 5%, the folded
    master close to the exact parameters and rendering to a close loss. A
    resort with no step between folds back nothing. (The drift is the
    reference's own: each copy row takes its own Adam step and the fold
    averages them. On the fat scene, where most splats are fat, the
    drift passes 5% by step 8, gsjax's LazyTrainer's as the port's:
    test_lazy_adam_reuse_matches_gsjax holds the port to gsjax's lazy
    trajectory there.)"""
    _, camt = _cams()
    target = torch.full((H, W, 3), 0.25)
    steps, K = LAZY_STEPS, LAZY_K
    scene = _scene("some-fat")
    ge = to_torch(scene)
    step = tt.make_step_fn(camt, CFG_T, torch.optim.Adam(ge.parameters(), lr=LAZY_LR))
    exact = np.asarray([float(step(ge, target)) for _ in range(steps)])

    g = to_torch(scene)
    opt = torch.optim.Adam(g.parameters(), lr=LAZY_LR)
    tr = tl.LazyTrainer(g, CFG_T, opt)
    before = {f: getattr(g, f).detach().clone() for f in _FIELDS}
    plan = tr.resort(camt)
    assert int((plan.pidx[plan.pidx < plan.n].bincount() > 1).sum()) > 30  # fat splats
    tr.resort(camt)  # nothing to fold
    for f in _FIELDS:
        assert torch.equal(getattr(g, f), before[f]), f
    lazy = []
    for s in range(steps):
        if s % K == 0:
            tr.resort(camt)
        lazy.append(float(tr.step(target, camt)))
    tr.sync()
    lazy = np.asarray(lazy)
    assert np.isfinite(lazy).all()
    np.testing.assert_allclose(lazy[0], exact[0], rtol=1e-5)
    assert lazy[-1] < lazy[0]
    assert (np.abs(lazy - exact) / np.abs(exact)).max() < 0.05
    assert float(opt.state[g.means]["step"]) == steps  # the home copies' count, written back
    with torch.no_grad():
        le = float(torch.mean((gt.render(g, camt, CFG_T) - target) ** 2))
        lee = float(torch.mean((gt.render(ge, camt, CFG_T) - target) ** 2))
    assert abs(le - lee) / lee < 0.05, (le, lee)
    for f in _FIELDS:
        a, b = getattr(ge, f).detach().numpy(), getattr(g, f).detach().numpy()
        assert np.isfinite(b).all()
        assert np.abs(a - b).max() / (np.abs(a).max() + 1e-6) < 0.05, f


@pytest.mark.parametrize("mode", ["orbit", "fixed-lazy"])
def test_bench_lazy_modes_on_the_cpu(mode, capsys):
    """bench.run's lazy modes at a tiny size: bench.py's JSON keys."""
    args = ["--quick", "--mode", mode, "--n", "400", "--width", "96", "--height", "64",
            "--device", "cpu", "--fat-cap", "2048"]
    args += ["--views", "2", "--steps-per-view", "2"] if mode == "orbit" else \
        ["--frames", "3", "--resort-every", "2"]
    assert trun.main(args) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "1080p_fwd_bwd_ms_per_frame" and line["unit"] == "ms"
    assert line["mode"] == mode and line["device"] == "cpu" and line["value"] > 0
    assert line["loss0"] > 0 and "final_loss" in line
    if mode == "orbit":
        assert (line["views"], line["steps_per_view"], line["resorts"]) == (2, 2, 2)
        assert line["sweep_deg"] == trun.SWEEP_DEG
    else:
        assert (line["frames"], line["resort_every"]) == (3, 2)


@pytest.mark.parametrize("overflow", [False, True])
def test_copy_slot_parents_match_the_reference_rule(overflow):
    """homesort.copy_slot_parents (a binary search of the bases) against
    the reference's rule (gsjax/render/homesort.py:739-751: each fat
    splat marked at its first slot, clamped to the last slot, then a
    running max), on random copy counts, with and without more copies
    than slots."""
    from gsjax_torch.render.homesort import copy_slot_parents

    rng = np.random.default_rng(5)
    for _ in range(50):
        n = int(rng.integers(1, 80))
        n_ex = np.where(rng.uniform(size=n) < rng.uniform(), rng.integers(1, 9, n), 0)
        total = int(n_ex.sum())
        fat_cap = max(1, total // 2) if overflow else total + int(rng.integers(1, 20))
        base = np.cumsum(n_ex) - n_ex
        marks = np.zeros(fat_cap, np.int64)
        for i in np.nonzero(n_ex)[0]:
            marks[min(base[i], fat_cap - 1)] = max(marks[min(base[i], fat_cap - 1)], i)
        want = np.maximum.accumulate(marks)
        got = copy_slot_parents(torch.from_numpy(n_ex.astype(np.int64)), fat_cap)
        np.testing.assert_array_equal(got.numpy(), want)
