"""gsjax_torch.tools.probe_scalars (I) against tools/probe_scalars.py."""

import numpy as np
import pytest
import torch

from gsjax_torch.tools import probe_scalars as tscalars

from test_torch_probe_common import G_I, _scalars_inputs, _scalars_reference


@pytest.mark.parametrize("kind", ["probe", "random"])
@pytest.mark.parametrize("variant", ["base", "smem", "vmem"])
def test_scalars_match_probe(variant, kind):
    stab, rows = _scalars_inputs(kind)
    out = tscalars.probe_scalars(variant, torch.from_numpy(stab), torch.from_numpy(rows))
    np.testing.assert_array_equal(out.numpy(), _scalars_reference(variant, stab, rows))
    if kind == "probe" and variant != "base":  # the probe's printed o[0, 0]
        assert int(out[-1]) == {"smem": sum(range(6 * G_I - 6, 6 * G_I)),
                                "vmem": sum(range(248, 254))}[variant]


def test_scalars_reduce_does_not_trace_in_the_probe():
    """The reference fault the port does not copy: `rows_ref[0]` is 1-D,
    so `raw[:, :CHUNK]` raises (tools/probe_scalars.py:37-38)."""
    stab, rows = _scalars_inputs("probe")
    with pytest.raises(IndexError):
        _scalars_reference("reduce", stab, rows)


@pytest.mark.parametrize("kind", ["probe", "random"])
def test_scalars_reduce_matches_intent(kind):
    """reduce: per block, six masked reductions over its first 128 ids —
    min and max of the ids ≡ r (mod 3), r = 0, 1, 2 (2^30 and −1 for an
    empty class) — summed with int32 wrap-around."""
    stab, rows = _scalars_inputs(kind)
    ids = rows[:, :128].astype(np.int64)
    want = np.zeros(G_I, np.int64)
    for r in range(3):
        m = np.mod(ids, 3) == r
        want += np.where(m, ids, 2**30).min(axis=1) + np.where(m, ids, -1).max(axis=1)
    want = want.astype(np.int32)  # numpy's int64 → int32 cast wraps
    out = tscalars.probe_scalars("reduce", torch.from_numpy(stab), torch.from_numpy(rows))
    np.testing.assert_array_equal(out.numpy(), want)
