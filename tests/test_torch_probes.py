"""gsjax_torch.tools — the Hopper counterparts of the four TPU probes G-J:
G (probe_mosaic) against the probe's kernel, and the probes' entry
points on the CPU."""

import numpy as np
import pytest
import torch

from gsjax_torch.tools import probe_chunk as tchunk
from gsjax_torch.tools import probe_compact as tcompact
from gsjax_torch.tools import probe_mosaic as tmosaic
from gsjax_torch.tools import probe_scalars as tscalars

from test_torch_probe_common import _mosaic_input, _mosaic_reference


@pytest.mark.parametrize("kind", ["probe", "random", "exit_at_once", "exit_after_one"])
def test_mosaic_matches_probe(kind):
    x = _mosaic_input(kind)
    o_ref, s_ref = _mosaic_reference(x)
    o, s = tmosaic.probe_mosaic(torch.from_numpy(x))
    np.testing.assert_array_equal(o.numpy(), o_ref)
    np.testing.assert_array_equal(s.numpy(), s_ref)


@pytest.mark.parametrize("module,argv", [
    (tmosaic, []), (tscalars, []), (tchunk, ["alpha,maskwalk"]),
    (tcompact, ["--nh", "4096"]),
])
def test_probe_entry_points_run_on_cpu(module, argv, capsys):
    module.main(["--device", "cpu", "--reps", "1", *argv])
    out = capsys.readouterr().out
    assert "host-clock" in out and "ms" in out


def test_probe_empty_raises_on_cpu():
    """The empty launch measures the card's launch floor: it has no plain
    version, so a CPU tensor raises and nothing is counted."""
    from gsjax_torch import kernels
    from gsjax_torch.tools import probe_empty

    kernels.reset_launches()
    with pytest.raises(ValueError, match="probe_empty"):
        probe_empty(torch.zeros(1, dtype=torch.int32), 1, 32)
    assert kernels.LAUNCHES["probe_empty"] == 0
