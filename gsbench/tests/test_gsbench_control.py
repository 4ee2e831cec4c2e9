"""The control of each cell's comparison, on the card: the reference
computed in TF32 (the configuration's float32 one step down) put in the
program's place must come out not correct under the cell's limits, while
the program comes out correct, on three seeds: the cell's scene,
resolution and limits, four views of its orbit (the readings the limits
were set from are gsbench.control's over all of them, PERF.md). The test
needs the card and skips without one."""

from __future__ import annotations

import pytest
import torch

from gsbench import compare, control, harness

SEEDS = (3_141_592_653, 3_141_592_654, 3_141_592_655)


@pytest.mark.parametrize("workload", [w["name"] for w in harness.manifest()["workloads"]])
def test_control_fails_where_the_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control is read at the timed widths on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    c = harness.cell(harness.manifest(), workload)
    c["config"]["cameras"]["views"] = 4
    for seed in SEEDS:
        r = control.readings(c, seed, 3.0, True, torch.device("cuda:0"))
        assert compare.judge(r["program"], c["limits"])[0], r
        assert not compare.judge(r["control_tf32"], c["limits"])[0], r
