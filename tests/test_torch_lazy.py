"""gsjax_torch parity: lazy frame plans (gsjax_torch/render/lazy.py)
against gsjax/render/lazy.py on the CPU — the plan's tables, the
extract into home order, the fold-back, a lazy render right after a
resort and a dead row's gradient."""

import jax
import numpy as np
import pytest
import torch

import gsjax_torch as gt
from gsjax.render import lazy as jl
from gsjax_torch.render import lazy as tl
from gsjax_torch.render.composite import att_table
from gsjax_torch.render.homesort import build_home_layout
from gsjax_torch.render.project import project

# module fixtures come in with the helpers (xla_vg: the one the others request)
from test_torch_lazy_common import (CFG_T, H, W, _FIELDS, _cams, _flat, _moments,
                                    _plan_from_gsjax, fat_ref, to_torch, xla_vg)


def test_frame_plan_tables_match_gsjax(fat_ref):
    """The port's plan of the fat scene against gsjax's: the source splat
    of each home row, the inverse structure, the home tiles, the tile
    starts and the overflow counters, equal; and the copy slots' parents
    of the port's layout."""
    pj = fat_ref["plan"]
    _, camt = _cams()
    plan = tl.build_frame_plan(to_torch(fat_ref["g"]), camt, CFG_T)
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
        p = project(to_torch(fat_ref["g"]), camt, CFG_T)
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


def test_extract_home_matches_gsjax(fat_ref):
    """Parameters and Adam moments in home order (a zero row for a dead
    row), bit-equal to gsjax's extract_home on its plan, the packed
    snapshot too."""
    g, pj = fat_ref["g"], fat_ref["plan"]
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
def test_fold_back_matches_gsjax(fat_ref, reduce, moments_mean):
    """master + reduce(hp − hp0) on the same numpy deltas as gsjax's
    fold_back (copy rows onto their parents; with primary-only moments
    the moments take their primary row's delta), within the bound
    test_home_gather_vjp_matches_gsjax holds the same segment sums to."""
    g, pj = fat_ref["g"], fat_ref["plan"]
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


def test_lazy_render_matches_exact(fat_ref):
    """Right after a resort: each live home row's fresh attributes equal
    the exact path's home table bit for bit (a copy row projects its
    parent, which kernel A copies), so the lazy render is within 2e-5 of
    the port's exact stream render (tests/test_lazy.py:64-78) and of
    gsjax's xla render (tests/test_torch_stream.py's bound)."""
    _, camt = _cams()
    g = to_torch(fat_ref["g"])
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
    assert np.abs(img.numpy() - fat_ref["img_xla"]).max() < 2e-5
    assert set(aux) == {"n_pair_overflow", "n_band_overflow", "n_fat_overflow",
                        "n_tile_overflow", "n_pairs", "transmittance"}
    assert aux["transmittance"].shape == (H, W)


def test_dead_row_gradient_is_zero_and_finite(fat_ref):
    """A dead home row reads the zero pad row (quaternion 0): its gradient
    is zero and finite; so is that of a row the fresh projection culls (a
    splat moved behind the camera after the resort)."""
    _, camt = _cams()
    g = to_torch(fat_ref["g"])
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
