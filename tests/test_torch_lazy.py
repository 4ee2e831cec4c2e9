"""gsjax_torch parity: lazy frame plans (gsjax_torch/render/lazy.py)
against gsjax/render/lazy.py on the CPU — the plan's tables, the
extract into home order, the fold-back, a lazy render right after a
resort, lazy training trajectories, a dead row's gradient, and the bench
runner's lazy modes.

tests/test_lazy.py's configuration cut to the port's test budget: n ≤ 400,
96×64 cameras, chunk 32, the fat budgets of tests/test_torch_train.py's
KW; gsjax's side keeps test_lazy.py's stream band knobs, which its plan
build also runs (band_blocks). gsjax's kernels A and B run in interpret
mode inside its plan build only; its Pallas blend is never called (the
renders it is held to come from its plain f32 `xla` backend), apart from
one lazy Adam trajectory through its LazyTrainer (its blend in interpret
mode, ~30 s), which the port's reused steps are held to. The gsjax side
is computed once per module."""

import dataclasses
import json

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
from gsjax_torch import train as tt
from gsjax_torch.bench import run as trun
from gsjax_torch.render import lazy as tl
from gsjax_torch.render.composite import att_table
from gsjax_torch.render.homesort import build_home_layout
from gsjax_torch.render.project import project

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
def ref():
    """gsjax's frame plan of the fat scene, its xla render, its lazy Adam
    trajectory (LazyTrainer, a resort every LAZY_K steps), and the thin
    scene's exact SGD trajectory (jax.grad through the xla backend). One
    compile of the xla render's value and gradient serves both scenes
    (the same shapes)."""
    camj, _ = _cams()
    cfg_x = gsjax.RenderConfig(backend="xla", tile_list_cap=512, chunk=32, **KW)

    def loss(g, target):
        img = gsjax.render(g, camj, cfg_x)
        return jnp.mean((img - target) ** 2), img

    vg = jax.jit(jax.value_and_grad(loss, has_aux=True))
    target = jnp.full((H, W, 3), 0.25, jnp.float32)
    out = {}
    g = _scene("fat")
    out["fat"] = dict(g=g, plan=jl.build_frame_plan(g, camj, CFG_J),
                      img_xla=np.asarray(vg(g, target)[0][1]))
    tr = jl.LazyTrainer(g, CFG_J, optax.adam(LAZY_LR))
    losses = []
    for s in range(LAZY_STEPS):
        if s % LAZY_K == 0:
            tr.resort(camj)
        losses.append(float(tr.step(target, camj)))
    out["fat"]["lazy"] = dict(losses=losses, final=tr.sync())

    g = _scene("thin")
    opt = optax.sgd(5e-2)
    ge, se, losses = g, opt.init(g), []
    for _ in range(4):
        (val, _), grads = vg(ge, target)
        updates, se = opt.update(grads, se, ge)
        ge = optax.apply_updates(ge, updates)
        losses.append(float(val))
    out["thin"] = dict(g=g, losses=losses, final=ge)
    return out


def test_frame_plan_tables_match_gsjax(ref):
    """The port's plan of the fat scene against gsjax's: the source splat
    of each home row, the inverse structure, the home tiles, the tile
    starts and the overflow counters, equal; and the copy slots' parents
    of the port's layout."""
    pj = ref["fat"]["plan"]
    _, camt = _cams()
    plan = tl.build_frame_plan(to_torch(ref["fat"]["g"]), camt, CFG_T)
    assert plan.inv_tail.shape[0] > 0 and (plan.pidx == plan.n).any()  # copies, dead rows
    assert int((plan.pidx[plan.pidx < plan.n].bincount() > 1).sum()) > 10  # fat splats
    for f in ("pidx", "inv", "inv_tail", "seg_base", "home_x", "home_y"):
        np.testing.assert_array_equal(getattr(plan, f).numpy(), np.asarray(getattr(pj, f)),
                                      err_msg=f)
    # the tiles' starts; the reference's last entry is its repacked stream's
    # padded length, the port's stream has no padding
    np.testing.assert_array_equal(plan.starts[:-1].numpy(), np.asarray(pj.starts)[:-1])
    assert int(plan.starts[-1]) == int(pj.ovf["n_pairs"]) <= int(pj.starts[-1])
    assert plan.ty0 == 0 and plan.tiles_x == pj.tiles_x and plan.band_rows == pj.band_rows
    assert plan.n == pj.n and plan.nh == pj.nh
    assert {k: int(v) for k, v in plan.ovf.items()} == \
        {k: int(v) for k, v in pj.ovf.items()}
    assert plan.pid.shape[0] == int(plan.ovf["n_pairs"]) == int(plan.starts[-1])
    # the layout's extras: the plan's, and each copy slot's parent as the
    # reference defines it (gsjax/render/homesort.py:739-751): the fat
    # splat whose run of slots holds it; past the last run, the last fat
    # splat
    with torch.no_grad():
        p = project(to_torch(ref["fat"]["g"]), camt, CFG_T)
        ph, layout, extras = build_home_layout(p, camt, CFG_T, return_extras=True)
    for k in ("inv", "inv_tail", "seg_base"):
        assert torch.equal(extras[k], getattr(plan, k)), k
    assert torch.equal(torch.where(ph.valid, extras["src_sorted"], plan.n), plan.pidx)
    seg = extras["seg_base"].numpy()
    n_ex = np.diff(seg)
    fat = np.nonzero(n_ex)[0]
    want = np.full(extras["parent_of_slot"].shape[0], fat[-1])
    for i in fat:
        want[seg[i]:seg[i + 1]] = i
    np.testing.assert_array_equal(extras["parent_of_slot"].numpy(), want)


def _moments(g, seed):
    """A pair of Adam-moment trees of g's shapes, from a seed (the second
    non-negative)."""
    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda x: rng.normal(0, 1e-3, x.shape).astype(np.float32), g)
    nu = jax.tree.map(lambda x: rng.uniform(0, 1e-6, x.shape).astype(np.float32), g)
    return mu, nu


def _flat(tree):
    return [np.asarray(getattr(tree, f)) for f in _FIELDS]


def test_extract_home_matches_gsjax(ref):
    """Parameters and Adam moments in home order (a zero row for a dead
    row), bit-equal to gsjax's extract_home on its plan, the packed
    snapshot too."""
    g, pj = ref["fat"]["g"], ref["fat"]["plan"]
    mu, nu = _moments(g, 1)
    hj, packed_j = jl.extract_home((g, mu, nu), pj, return_packed=True)
    plan = _plan_from_gsjax(pj, pj.n)
    master = [torch.from_numpy(np.array(a)) for a in _flat(g) + _flat(mu) + _flat(nu)]
    master.append(torch.tensor(7.0))  # a step count passes through
    home, parts = tl.extract_home(master, plan, return_packed=True)
    assert home[-1] is master[-1]
    want = _flat(hj[0]) + _flat(hj[1]) + _flat(hj[2])
    for a, b in zip(home, want):
        np.testing.assert_array_equal(a.numpy(), b)
    assert [x.shape[1] for x in parts] == [56, 13]  # 3 × 23 columns: two groups
    np.testing.assert_array_equal(torch.cat(parts, 1).numpy(), np.asarray(packed_j))
    dead = plan.pidx == plan.n
    assert dead.any() and not home[0][dead].any()
    # the snapshot is a buffer of its own: writing a tensor leaves it be
    home[0].add_(1.0)
    np.testing.assert_array_equal(torch.cat(parts, 1).numpy(), np.asarray(packed_j))


@pytest.mark.parametrize("reduce", ["mean", "sum"])
@pytest.mark.parametrize("moments_mean", [False, True])
def test_fold_back_matches_gsjax(ref, reduce, moments_mean):
    """master + reduce(hp − hp0) on the same numpy deltas as gsjax's
    fold_back (copy rows onto their parents; with primary-only moments
    the moments take their primary row's delta), within the bound
    test_home_gather_vjp_matches_gsjax holds the same segment sums to."""
    g, pj = ref["fat"]["g"], ref["fat"]["plan"]
    mu, nu = _moments(g, 2)
    master_j = (g, mu, nu)
    h0_j, packed_j = jl.extract_home(master_j, pj, return_packed=True)
    rng = np.random.default_rng(3)
    hp_j = jax.tree.map(lambda x: x + rng.normal(0, 1e-2, x.shape).astype(np.float32), h0_j)
    copy_j = (jax.tree.map(lambda _: True, g),
              *(jax.tree.map(lambda _: moments_mean, t) for t in (mu, nu)))
    folded_j = jl.fold_back(master_j, hp_j, packed_j, pj, reduce=reduce, copy_cols=copy_j)

    plan = _plan_from_gsjax(pj, pj.n)
    tt_ = lambda tree: [torch.from_numpy(np.array(a)) for a in _flat(tree)]
    master = tt_(g) + tt_(mu) + tt_(nu)
    hp = tt_(hp_j[0]) + tt_(hp_j[1]) + tt_(hp_j[2])
    hp0 = tl.extract_home(master, plan, return_packed=True)[1]
    copy = [True] * 5 + [moments_mean] * 10
    folded = tl.fold_back(master, hp, hp0, plan, reduce=reduce, copy_cols=copy)
    want = _flat(folded_j[0]) + _flat(folded_j[1]) + _flat(folded_j[2])
    for i, (a, b) in enumerate(zip(folded, want)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5, err_msg=str(i))
    # a splat with copies folded more than its primary row's delta
    moved = np.abs(want[0] - np.asarray(g.means)).max(axis=1)
    assert (moved > 0).sum() > 100


def test_lazy_render_matches_exact(ref):
    """Right after a resort: each live home row's fresh attributes equal
    the exact path's home table bit for bit (a copy row projects its
    parent, which kernel A copies), so the lazy render is within 2e-5 of
    the port's exact stream render (tests/test_lazy.py:64-78) and of
    gsjax's xla render (tests/test_torch_stream.py's bound)."""
    _, camt = _cams()
    g = to_torch(ref["fat"]["g"])
    plan = tl.build_frame_plan(g, camt, CFG_T)
    hp = gt.Gaussians(*tl.extract_home([getattr(g, f) for f in _FIELDS], plan))
    with torch.no_grad():
        img_exact = gt.render(g, camt, CFG_T)
        ph, layout = build_home_layout(project(g, camt, CFG_T), camt, CFG_T)
        att = tl.lazy_cols(hp, camt, CFG_T)
        img, aux = tl.lazy_render(hp, camt, CFG_T, plan, return_aux=True)
    live = ph.valid
    assert bool((live & (layout.perm >= g.means.shape[0])).any())  # live copy rows
    assert torch.equal(att[live], att_table(ph)[live])
    assert img.shape == (H, W, 3)
    assert float((img - img_exact).abs().max()) <= 2e-5
    assert np.abs(img.numpy() - ref["fat"]["img_xla"]).max() < 2e-5
    assert set(aux) == {"n_pair_overflow", "n_band_overflow", "n_fat_overflow",
                        "n_tile_overflow", "n_pairs", "transmittance"}
    assert aux["transmittance"].shape == (H, W)


def test_lazy_sgd_thin_matches_gsjax_exact(ref):
    """A resort before each of 4 SGD steps on the thin scene: the lazy
    trajectory's losses and final parameters equal gsjax's exact xla
    trajectory (tests/test_lazy.py:81-117's bounds: the fold-back of one
    row per splat under a gradient-linear optimizer is exact)."""
    _, camt = _cams()
    g = to_torch(ref["thin"]["g"])
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
    np.testing.assert_allclose(losses, ref["thin"]["losses"], rtol=1e-5)
    for f in _FIELDS:
        np.testing.assert_allclose(getattr(g, f).detach().numpy(),
                                   np.asarray(getattr(ref["thin"]["final"], f)), atol=1e-5,
                                   err_msg=f)


def test_lazy_adam_reuse_matches_gsjax(ref):
    """The reused steps against gsjax: Adam with a resort every LAZY_K
    steps on the fat scene (most splats fat, so most rows take their own
    Adam step between resorts and the fold averages them), the port's
    LazyTrainer against gsjax's on the same scene and camera. Losses and
    folded parameters within 1e-5: the steps that reuse a stale layout
    are the reference's, not only the first step after a resort."""
    _, camt = _cams()
    g = to_torch(ref["fat"]["g"])
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
    want = ref["fat"]["lazy"]
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


def test_dead_row_gradient_is_zero_and_finite(ref):
    """A dead home row reads the zero pad row (quaternion 0): its gradient
    is zero and finite; so is that of a row the fresh projection culls (a
    splat moved behind the camera after the resort)."""
    _, camt = _cams()
    g = to_torch(ref["fat"]["g"])
    plan = tl.build_frame_plan(g, camt, CFG_T)
    hp = gt.Gaussians(*tl.extract_home([getattr(g, f) for f in _FIELDS], plan))
    dead = plan.pidx == plan.n
    culled = torch.nonzero(~dead).squeeze(1)[:3]
    with torch.no_grad():
        hp.means[culled, 2] = -5.0
    torch.mean((tl.lazy_render(hp, camt, CFG_T, plan) - 0.25) ** 2).backward()
    assert dead.sum() > 0
    for f in _FIELDS:
        grad = getattr(hp, f).grad
        assert torch.isfinite(grad).all(), f
        assert not grad[dead].any() and not grad[culled].any(), f
    assert hp.means.grad[~dead].abs().max() > 0


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
