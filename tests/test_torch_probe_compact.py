"""gsjax_torch.tools.probe_compact (H) against tools/probe_compact.py's
position arithmetic."""

import numpy as np
import pytest
import torch

from gsjax_torch.tools import probe_compact as tcompact

from test_torch_probe_common import NH_H, _prefix_reference


@pytest.mark.parametrize("kind", ["probe", "random"])
@pytest.mark.parametrize("classes", [1, 3, 9])
def test_compact_matches_position_arithmetic(classes, kind):
    """Entry fill + pref − 1 for each alive lane, fill summing the totals
    (max of the inclusive prefix) of every (subgroup, class) before, in
    the probe's order (tools/probe_compact.py:67-78)."""
    rng = np.random.default_rng(14 + classes)
    if kind == "probe":
        mask = np.full(NH_H, tcompact.PROBE_MASK, np.int32)
    else:
        mask = rng.integers(-2**31, 2**31, NH_H, dtype=np.int64).astype(np.int32)
        mask[:128] = 0  # an empty subgroup
    vals = rng.normal(size=(8, NH_H)).astype(np.float32)
    ng = NH_H // 128
    alive = ((mask.reshape(ng, 1, 128) >> np.arange(classes)[None, :, None]) & 1)
    pref = _prefix_reference(alive.reshape(ng * classes, 128).astype(np.int32))
    want = np.zeros((8, NH_H * classes), np.float32)
    fill = 0
    for k in range(ng * classes):
        a = alive.reshape(-1, 128)[k] > 0
        pos = fill + pref[k] - 1
        want[:, pos[a]] = vals[:, (k // classes) * 128 + np.nonzero(a)[0]]
        fill += int(pref[k].max())
    stream, count = tcompact.probe_compact(torch.from_numpy(mask.reshape(1, NH_H)),
                                           torch.from_numpy(vals), classes)
    assert stream.shape == (8, NH_H * classes) and count.dtype == torch.int32
    assert int(count[0]) == fill
    np.testing.assert_array_equal(stream[:, :fill].numpy(), want[:, :fill])
