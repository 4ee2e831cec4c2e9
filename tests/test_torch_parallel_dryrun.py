"""gsjax_torch: the torch dryrun_multichip against MULTICHIP_r05.json (the
reference's recorded run), and two gloo processes of two bands each
against one process of four (gsjax_torch/parallel/mp_worker.py,
tests/test_multiprocess.py's claim)."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from gsjax_torch.parallel import mp_worker
from gsjax_torch.parallel.dryrun import dryrun_multichip
from gsjax_torch.parallel.mesh import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


def test_dryrun_multichip_reproduces_multichip_r05():
    """dryrun_multichip(8) on the CPU (the port's plain path, the anchor's
    own 2,048-splat 64×256 scene): the cuts and n_pairs of the record,
    its loss within rel 1e-4, the sharded gradients the whole image's
    (grads_match), every overflow counter 0."""
    with open(os.path.join(ROOT, "MULTICHIP_r05.json")) as fh:
        tail = json.load(fh)["tail"]
    loss = float(re.search(r"loss=([0-9.]+)", tail).group(1))
    cuts = json.loads(re.search(r"cuts=(\[[0-9, ]+\])", tail).group(1))
    n_pairs = int(re.search(r"'n_pairs': ([0-9]+)", tail).group(1))
    assert "grads_match=ok" in tail
    out = dryrun_multichip(8, device="cpu")
    assert out["cuts"] == cuts
    assert out["aux"]["n_pairs"] == n_pairs
    assert out["loss"] == pytest.approx(loss, rel=1e-4)
    assert out["loss"] == pytest.approx(out["loss_single"], rel=1e-5)
    assert max(out["grad_err"].values()) < 1e-4
    assert all(v == 0 for k, v in out["aux"].items() if k.endswith("overflow"))


def test_gloo_two_processes_match_one_process_mesh(tmp_path):
    """Two ranks of two bands over a gloo group (`python -m
    gsjax_torch.parallel.mp_worker`, a file:// store): their 3 losses
    those of one process with four bands within rtol 1e-5, and falling,
    and their render_sharded frame the one process's.
    Each process has 120 s; one that fails or times out fails the test."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    store = tmp_path / "store"
    procs = [subprocess.Popen([sys.executable, "-m", "gsjax_torch.parallel.mp_worker", str(r),
                               "2", str(store), str(tmp_path), "--device", "cpu"],
                              cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), logs
    got = [float(v) for v in (tmp_path / "losses.txt").read_text().split()]
    want, frame = mp_worker.run(make_mesh(4, "cpu"))
    assert len(got) == mp_worker.STEPS
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0], got
    # render_sharded over the group: the ranks' bands summed into one frame
    np.testing.assert_allclose(np.load(tmp_path / "frame.npy"), frame, rtol=0, atol=1e-6)
