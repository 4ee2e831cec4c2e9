"""A cell of the manifest cut to a size the CPU runs in seconds (the
port's plain versions, the same harness), for the rehearsal tests.

The cells' limits are set from readings at the timed sizes (PERF.md). A
tiny scene's splats are tens of pixels wide at 96x64 (garden_like grows
them as 1/sqrt(n)), so more of Adam's first, sign-like step falls on
gradients below their rounding: its training numbers are held to
TRAINING_LIMITS instead, which a state left unchanged (1) and the half
batch still exceed."""

from __future__ import annotations

import copy
import time

import torch

from gsbench import harness, run

SEED = 2_718_281_828  # above 2**31: seeds need more than 32 signed bits
SIZES = {"bonsai": 1500, "bonsai-sh3": 1500, "garden": 2500}
TRAINING_LIMITS = {"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 1e-2}


def cell(workload: str, views: int = 4, width: int = 96, height: int = 64) -> dict:
    c = copy.deepcopy(harness.cell(harness.manifest(), workload))
    c["config"]["scene"]["n"] = SIZES[c["config"]["name"]]
    c["config"]["cameras"].update(views=views, width=width, height=height)
    if c["traffic"]["kind"] == "serve":
        c["traffic"]["sample_within"] = 3  # the first three requests: a loaded CPU serves few
    else:
        c["limits"] = dict(TRAINING_LIMITS)
    return c


def rehearse(workload: str, seconds: float = 2.0, trace: bool = False, seed: int = SEED,
             c: dict | None = None) -> dict:
    """One run of the cell on the CPU: the result line as a dict."""
    man = harness.manifest()
    return run.run_cell(man, c or cell(workload), workload, seed, seconds, trace,
                        torch.device("cpu"), start=time.monotonic())
