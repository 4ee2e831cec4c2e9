"""gsjax_torch parity: a band's prefilter, slice and bins on the
tile-sharded path (gsjax_torch/render/homesort.py, binning.py) and the
band frame plan (render/lazy.build_band_plan), against
gsjax/render/homesort.py, binning.py and lazy.py on the same projected
splats — bit for bit, including caps that drop rows (counted), a band's
live rows below its static rows, and tile row 8 of a 9-row image as
band 4 of 8 (the uneven split)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsjax
from gsjax.render import binning as jb
from gsjax.render import homesort as jh
from gsjax.render import lazy as jl
from gsjax_torch.parallel.render_sharded import _render_band
from gsjax_torch.render import binning as tb
from gsjax_torch.render import homesort as th
from gsjax_torch.render import lazy as tl

from test_torch_parallel_common import (BAND_H, BAND_W, CFG_BAND_J, CFG_BAND_T,
                                        assert_proj_equal, band_ref, cams, layout_to_torch,
                                        proj_to_torch, to_torch)

TILES_X, TILES_Y = BAND_W // 16, BAND_H // 16  # 6 × 9

# (ty0, band rows, live rows or None, cap or None = the slack's): a band
# inside the image, fewer live rows than static ones, a cap that drops
# rows, and the last rows of an uneven split (9 rows over 8 bands of 2:
# band 4 starts at row 8, band 5 past the image)
PREFILTER_CASES = {
    "band": (3, 2, None, None),
    "rows-live": (2, 3, 1, None),
    "drops": (4, 2, None, 96),
    "last-row": (8, 2, None, None),
}
SLICE_CASES = {
    "band": (3, 2, None, None),
    "rows-live": (2, 3, 1, None),
    "drops": (4, 2, None, 64),
    "last-row": (8, 2, None, None),
    "past-image": (10, 2, None, None),
}


def _pref_cap(n, band, cap):
    if cap is not None:
        return cap
    return min(th.band_prefilter_cap(n, TILES_Y, band), -(-n // 4096) * 4096)


def test_band_prefilter_matches_gsjax(band_ref):
    """The compacted band scene (rows, validity, the pad rows), the
    splats dropped past the cap and each row's splat, bit-equal to
    gsjax's on its projected splats, in each of PREFILTER_CASES; and both
    caps' arithmetic, integer for integer."""
    pj = band_ref["p"]
    n = pj.depth.shape[0]
    pt = proj_to_torch(pj)
    for case, (ty0, band, live, cap) in PREFILTER_CASES.items():
        rows = band if live is None else live
        cap_n = _pref_cap(n, band, cap)
        want = jax.jit(
            lambda p, t: jh.band_prefilter(p, t, rows, TILES_Y, TILES_X, cap_n, CFG_BAND_J,
                                           return_idx=True))(pj, jnp.int32(ty0))
        got = th.band_prefilter(pt, ty0, rows, TILES_Y, TILES_X, cap_n, CFG_BAND_T,
                                return_idx=True)
        assert_proj_equal(got[0], want[0], case)
        assert int(got[1]) == int(want[1]), case
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]), err_msg=case)
        if case == "drops":
            assert int(got[1]) > 0
        else:  # the pad rows past the band's
            assert int(got[1]) == 0 and not got[0].valid.all(), case
    for n in (100, 4096, 9999, 1_200_000, 5_720_000):
        for tiles_y in (1, 9, 68):
            for band in (1, 2, 3, 9, 17):
                for slack in (1.0, 2.0, 2.5):
                    args = (n, tiles_y, band, slack)
                    assert th.band_prefilter_cap(*args) == jh.band_prefilter_cap(*args), args
                    assert th.band_slice_cap(*args) == jh.band_slice_cap(*args), args


def test_band_select_gradient_is_the_gathers():
    """_BandSelect's backward (a gather through the inverse positions)
    equals autograd's through a plain index and gsjax's custom VJP, for a
    compaction that drops splats and one that pads."""
    rng = np.random.default_rng(1)
    n = 300
    packed = torch.from_numpy(rng.normal(size=(n + 1, 11)).astype(np.float32))
    packed[n] = 0.0
    for cap in (120, 400):
        relevant = rng.uniform(size=n) < 0.6
        order = np.concatenate([np.nonzero(relevant)[0], n + np.nonzero(~relevant)[0]])
        inv = np.empty(n, np.int64)
        inv[np.where(order < n, order, order - n)] = np.arange(n)
        inv = np.where(relevant, inv, cap)
        order = order[:cap]
        idx = torch.from_numpy(np.where(order < n, order, n))
        ct = torch.from_numpy(rng.normal(size=(idx.shape[0], 11)).astype(np.float32))
        x = packed.clone().requires_grad_()
        th._BandSelect.apply(x, idx, torch.from_numpy(inv)).backward(ct)
        x_plain = packed.clone().requires_grad_()
        x_plain[idx].backward(ct)
        want = x_plain.grad.clone()
        want[n] = 0.0  # the pad row takes no gradient
        assert torch.equal(x.grad, want), cap
        _, vjp = jax.vjp(lambda a: jh._band_select(a, jnp.asarray(idx.numpy()),
                                                   jnp.asarray(inv)), jnp.asarray(packed))
        np.testing.assert_array_equal(x.grad.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]))


@pytest.mark.parametrize("case", list(SLICE_CASES))
def test_slice_band_rows_matches_gsjax(band_ref, case):
    """The band's window of gsjax's home layout: rows, band-local
    seg_starts, the rows dropped past the cap, a side array's window and
    its start, bit-equal to gsjax's; the gradient is zero outside the
    window (the slice's transpose pads it)."""
    ty0, band, live, cap = SLICE_CASES[case]
    ph, lay = band_ref["ph"], band_ref["lay"]
    nh = ph.depth.shape[0]
    if cap is None:
        cap = th.band_slice_cap(nh, TILES_Y, band)
    src = band_ref["extras"]["src_sorted"]
    want = jax.jit(lambda p, l, s, t: jh.slice_band_rows(p, l, t, band, cap, live,
                                                         extra_rows=(s,)))(
        ph, lay, src, jnp.int32(ty0))
    pt = proj_to_torch(ph)
    pt = dataclasses.replace(pt, mean2d=pt.mean2d.clone().requires_grad_())
    got = th.slice_band_rows(pt, layout_to_torch(lay), ty0, band, cap, live,
                             extra_rows=(torch.from_numpy(np.array(src)),))
    assert_proj_equal(got[0], want[0], case)
    for f in ("perm", "seg_starts", "home_x", "home_y", "win"):
        np.testing.assert_array_equal(getattr(got[1], f).numpy(),
                                      np.asarray(getattr(want[1], f)), err_msg=f)
    assert int(got[2]) == int(want[2])
    assert (int(got[2]) > 0) == (case == "drops")
    np.testing.assert_array_equal(got[3][0].numpy(), np.asarray(want[3][0]))
    assert got[4] == int(want[4])
    w = torch.from_numpy(np.random.default_rng(2).normal(size=got[0].mean2d.shape)
                         .astype(np.float32))
    (got[0].mean2d * w).sum().backward()
    s0, c = got[4], got[0].depth.shape[0]
    assert torch.equal(pt.mean2d.grad[s0:s0 + c], w)
    assert not pt.mean2d.grad[:s0].any() and not pt.mean2d.grad[s0 + c:].any()


def test_band_bins_match_gsjax(band_ref):
    """build_tile_bins(rows_live=...) on the sliced band (kernel B's band
    check at [ty0, ty0 + rows_live), the band's tiles_x·band_rows tiles):
    the pair set in (tile, depth, pid) order and the tile starts equal to
    gsjax's one-sort path (pair_repack=False), for a band with fewer live
    rows than static ones and for the uneven split's last image row."""
    ph, lay = band_ref["ph"], band_ref["lay"]
    camj, camt = cams(BAND_W, BAND_H)
    cfg_j = gsjax.RenderConfig(**{**CFG_BAND_J.__dict__, "pair_repack": False})
    for case in ("rows-live", "last-row"):
        ty0, band, live, _ = SLICE_CASES[case]
        cap = th.band_slice_cap(ph.depth.shape[0], TILES_Y, band)

        @jax.jit
        def ref(p, l, t):
            p2, l2, _ = jh.slice_band_rows(p, l, t, band, cap, live)
            bins = jb.build_tile_bins(p2, camj, cfg_j, ty0=t, band_rows=band, anchor="home",
                                      layout=l2, rows_live=live)
            return bins.pid_sorted, bins.tile_starts, bins.n_pairs

        pid_j, starts_j, n_j = ref(ph, lay, jnp.int32(ty0))
        p2, l2, _ = th.slice_band_rows(proj_to_torch(ph), layout_to_torch(lay), ty0, band,
                                       cap, live)
        bins = tb.build_tile_bins(p2, camt, CFG_BAND_T, ty0=ty0, band_rows=band,
                                  anchor="home", layout=l2, rows_live=live)
        assert int(bins.n_pairs) == int(n_j) > 0, case
        np.testing.assert_array_equal(bins.pid_sorted.numpy(), np.asarray(pid_j)[: int(n_j)],
                                      err_msg=case)
        np.testing.assert_array_equal(bins.tile_starts.numpy(), np.asarray(starts_j),
                                      err_msg=case)
        assert bins.tile_starts.shape[0] == TILES_X * band + 1


def test_band_plan_matches_gsjax(band_ref):
    """build_band_plan: each home row's global splat, the rebased inverse
    structure, the home tiles and the counters equal gsjax's; the lazy
    render of the plan within 2e-5 of _render_band's exact band
    (test_lazy.py's claim), for the top band and a band with fewer live
    rows."""
    g = band_ref["g"]
    camj, camt = cams(BAND_W, BAND_H)
    gt_ = to_torch(g)
    for ty0, band, live in ((0, 4, None), (4, 4, 3)):
        pj = jl.build_band_plan(g, camj, CFG_BAND_J, ty0, band, live)
        plan = tl.build_band_plan(gt_, camt, CFG_BAND_T, ty0, band, live)
        for f in ("pidx", "inv", "inv_tail", "seg_base", "home_x", "home_y"):
            np.testing.assert_array_equal(getattr(plan, f).numpy(), np.asarray(getattr(pj, f)),
                                          err_msg=f)
        assert plan.n == pj.n and plan.nh == pj.nh and plan.ty0 == ty0
        assert {k: int(v) for k, v in plan.ovf.items()} == \
            {k: int(v) for k, v in pj.ovf.items()}
        assert (plan.pidx < plan.n).any() and (plan.pidx == plan.n).any()
        with torch.no_grad():
            hp = gt_.__class__(*tl.extract_home([getattr(gt_, f) for f in tl.FIELDS], plan))
            img_l = tl.lazy_render(hp, camt, CFG_BAND_T, plan)
            img_e, _ = _render_band(gt_, camt, CFG_BAND_T, ty0, band, live)
        d = (img_l - img_e[:, :BAND_W]).abs().max()
        assert float(d) <= 2e-5, (ty0, float(d))


def test_build_band_bins_is_the_band_chain(band_ref):
    """binning.build_band_bins, the one copy of the band's chain that
    _render_band, build_band_plan and chip_smoke's stage timer run:
    bit-equal to the band functions called in turn with their default
    caps, its stages reported in order; unrestricted it is the whole
    image's layout, and a plan's extras need the restriction."""
    camj, camt = cams(BAND_W, BAND_H)
    p = proj_to_torch(band_ref["p"])
    ty0, band, live = 2, 3, 1
    n = p.depth.shape[0]
    with torch.no_grad():
        pb, n_pref = th.band_prefilter(p, ty0, live, TILES_Y, TILES_X, _pref_cap(n, band, None),
                                       CFG_BAND_T)
        ph, lay = th.build_home_layout(pb, camt, CFG_BAND_T)
        cap = th.band_slice_cap(lay.perm.shape[0], TILES_Y, band)
        ph, lay, n_sliced = th.slice_band_rows(ph, lay, ty0, band, cap, live)
        bins = tb.build_tile_bins(ph, camt, CFG_BAND_T, ty0=ty0, band_rows=band,
                                  anchor="home", layout=lay, rows_live=live)
        stages = []
        ph2, lay2, bins2, n_pref2, n_sliced2 = tb.build_band_bins(
            p, camt, CFG_BAND_T, ty0, band, live,
            on_stage=lambda name, out: stages.append((name, type(out).__name__)))
        assert_proj_equal(ph2, ph)
        assert torch.equal(lay2.seg_starts, lay.seg_starts) and torch.equal(lay2.perm, lay.perm)
        assert torch.equal(bins2.pid_sorted, bins.pid_sorted)
        assert torch.equal(bins2.tile_starts, bins.tile_starts)
        assert (int(n_pref2), int(n_sliced2)) == (int(n_pref), int(n_sliced))
        assert stages == [("prefilter", "ProjectedSplats"), ("home_layout", "ProjectedSplats"),
                          ("slice", "ProjectedSplats"), ("bins_sort", "TileBins")]
        ph3, lay3, _, n_pref3, n_sliced3 = tb.build_band_bins(p, camt, CFG_BAND_T, 0, TILES_Y)
        ph4, lay4 = th.build_home_layout(p, camt, CFG_BAND_T)
        assert_proj_equal(ph3, ph4)
        assert torch.equal(lay3.seg_starts, lay4.seg_starts) and (n_pref3, n_sliced3) == (0, 0)
        with pytest.raises(ValueError, match="restrict"):
            tb.build_band_bins(p, camt, CFG_BAND_T, 0, TILES_Y, return_extras=True)
