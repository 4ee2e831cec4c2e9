"""gsjax_torch parity: the tile-sharded path's autotune
(gsjax_torch/core/autotune.py: _rect_y_ranges, derive_row_cuts,
derive_shard_caps) against gsjax/core/autotune.py on a top-heavy scene of
fat splats over 9 tile rows — integer for integer — and the derived cuts
and caps training one equalized step with nothing dropped."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.core import autotune as ja
from gsjax_torch.core import autotune as ta
from gsjax_torch.core.gaussians import FIELDS
from gsjax_torch.parallel.mesh import make_mesh
from gsjax_torch.parallel.render_sharded import (make_train_step, make_train_step_equalized,
                                                 pad_target, pad_target_rows)

from test_torch_parallel_common import (BAND_H, BAND_W, CFG_BAND_J, CFG_BAND_T, band_scene,
                                        cams, to_torch)

CAPS = dict(fat_cap=2048, fat_live_cap=1024)


def _skewed():
    """The band scene with every mean's y set to −0.8·|y| (the dryrun's
    skew): most splats in the top rows."""
    g = band_scene()
    means = np.array(g.means)
    means[:, 1] = -np.abs(means[:, 1]) * 0.8
    return dataclasses.replace(g, means=jnp.asarray(means))


@pytest.fixture(scope="module")
def occ():
    """Both packages' measuring pass of the skewed scene (gsjax's kernels
    A and B in interpret mode), once."""
    camj, camt = cams(BAND_W, BAND_H)
    g = _skewed()
    gt_ = to_torch(g)
    mj = ja.measure_occupancy(g, camj, CFG_BAND_J)
    mt = ta.measure_occupancy(gt_, camt, CFG_BAND_T)
    for k in ("n_pairs", "n_valid", "n_copies"):
        assert mt[k] == int(mj[k]), k
    np.testing.assert_array_equal(mt["cand"], mj["cand"])
    return dict(g=g, gt=gt_, mj=mj, mt=mt)


def test_rect_y_ranges_match_gsjax(occ):
    """Each splat's footprint tile rows (tiles_y + 4 where it has none)."""
    camj, camt = cams(BAND_W, BAND_H)
    want = ja._rect_y_ranges(occ["g"], camj, CFG_BAND_J)
    got = ta._rect_y_ranges(occ["gt"], camt, CFG_BAND_T)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert (got[1] > got[0]).all() and got[0].min() == 0


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_derive_row_cuts_match_gsjax(occ, n_devices):
    """The equal-content cuts, with and without a per-row weight, and on
    this top-heavy scene narrower top bands."""
    for w in (0.0, 7.5):
        got = ta.derive_row_cuts(None, None, CFG_BAND_T, n_devices, m=occ["mt"], row_weight=w)
        want = ja.derive_row_cuts(None, None, CFG_BAND_J, n_devices, m=occ["mj"], row_weight=w)
        assert got == [int(c) for c in want], (w, got, want)
        assert got[0] == 0 and got[-1] == 9 and all(b > a for a, b in zip(got, got[1:]))


def test_derive_shard_caps_match_gsjax(occ):
    """The prefilter, slice, pair and fat caps for uniform grids (the
    default origins and given ones) and for the equal-content bands, at
    two slacks, with the fat caps set and unset."""
    camj, camt = cams(BAND_W, BAND_H)
    cuts = ta.derive_row_cuts(None, None, CFG_BAND_T, 4, m=occ["mt"])
    bands = [(cuts[i], cuts[i + 1] - cuts[i]) for i in range(4)]
    keys = ("shard_prefilter_cap", "shard_slice_cap", "pair_cap", "fat_cap", "fat_live_cap",
            "repack_rows")
    for caps in (CAPS, dict(fat_cap=None, fat_live_cap=None)):
        cfg_t = dataclasses.replace(CFG_BAND_T, **caps)
        cfg_j = dataclasses.replace(CFG_BAND_J, **caps)
        for kw in (dict(band_rows=1), dict(band_rows=2), dict(band_rows=3, origins=[0, 5]),
                   dict(bands=bands), dict(bands=bands, slack=2.0)):
            got = ta.derive_shard_caps(occ["gt"], camt, cfg_t, m=occ["mt"], **kw)
            want = ja.derive_shard_caps(occ["g"], camj, cfg_j, m=occ["mj"], **kw)
            assert {k: getattr(got, k) for k in keys} == {k: getattr(want, k) for k in keys}, kw
    with pytest.raises(ValueError, match="band_rows"):
        ta.derive_shard_caps(occ["gt"], camt, CFG_BAND_T, m=occ["mt"])


def test_derived_cuts_and_caps_train_one_step(occ):
    """derive_row_cuts + derive_shard_caps(bands=...) into the equalized
    step over 4 bands: nothing dropped, the loss and the step those of the
    one-band step (at the full-image caps)."""
    _, camt = cams(BAND_W, BAND_H)
    cfg = dataclasses.replace(CFG_BAND_T, **CAPS)
    cuts = ta.derive_row_cuts(occ["gt"], camt, cfg, 4)
    bands = [(cuts[i], cuts[i + 1] - cuts[i]) for i in range(4)]
    cfg_b = ta.derive_shard_caps(occ["gt"], camt, cfg, bands=bands)
    assert cfg_b.shard_prefilter_cap and cfg_b.shard_slice_cap
    target = np.full((BAND_H, BAND_W, 3), 0.2, np.float32)
    out = []
    for make, cfg_s, n, pad, kw in (
            (make_train_step_equalized, cfg_b, 4, pad_target_rows,
             dict(row_cuts=cuts)), (make_train_step, cfg, 1, pad_target, {})):
        g = to_torch(occ["g"])
        step = make(camt, cfg_s, make_mesh(n, "cpu"), torch.optim.Adam(g.parameters(), 1e-3),
                    **kw)
        arg = max(b for _, b in bands) if kw else 1
        loss, aux = step(g, pad(cfg_s, camt, target, arg))
        out.append((float(loss), {k: int(v) for k, v in aux.items()},
                    [getattr(g, f).detach() for f in FIELDS]))
    (leq, aux, peq), (l1, _, p1) = out
    assert all(aux[k] == 0 for k in ("n_pair_overflow", "n_band_overflow", "n_fat_overflow"))
    assert leq == pytest.approx(l1, rel=1e-5)
    for f, a, b in zip(FIELDS, peq, p1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=0, err_msg=f)
