"""gsjax_torch parity: core/transforms against gsjax's scene edits."""

import numpy as np
import pytest

import gsjax
import gsjax_torch as gt

from test_torch_io_common import _EDITS, _FIELDS, _np, to_torch


@pytest.mark.parametrize("edit", list(_EDITS))
def test_transforms_match_gsjax(edit):
    from conftest import make_random_scene

    gj = make_random_scene(np.random.default_rng(12), n=40)
    gp = to_torch(gj)
    ej, ep = _EDITS[edit](gsjax.transforms, gj), _EDITS[edit](gt.transforms, gp)
    assert ep.n == ej.n and ep.device == gp.device
    if edit == "crop_box":
        assert ep.n < 40
    for f in _FIELDS:
        # elementwise edits bit-equal; rotate's matmul and norm to rounding
        np.testing.assert_allclose(_np(getattr(ep, f)), np.asarray(getattr(ej, f)),
                                   rtol=0, atol=2e-6 if edit == "rotate" else 0, err_msg=f)
    if edit != "crop_box":  # the edit is differentiable back to g
        ep.means.sum().backward()
        assert gp.means.grad is not None and bool(gp.means.grad.abs().max() > 0)
    if edit == "limit_box":
        with pytest.raises(ValueError):
            gt.transforms.limit_box(gp, 1, -1, 0, 1, 0, 1)
