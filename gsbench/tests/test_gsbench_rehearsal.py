"""Each cell's traffic mix end to end on the CPU at a tiny size, through
the port's plain versions: correct, the result line's keys, no device
metric, and neither JAX nor the JAX package loaded."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from gsbench import harness
from gsbench.tests import tiny

WORKLOADS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_rehearsal_is_correct_and_writes_no_device_metric(workload):
    out = tiny.rehearse(workload)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["metrics"] == {}
    assert out["device"]["platform"] == "cpu"
    assert set(out["checks"]) == set(harness.cell(harness.manifest(), workload)["limits"])
    json.dumps(out, allow_nan=False)


def test_traced_rehearsal_writes_no_device_metric():
    out = tiny.rehearse("bonsai-sh3.train-lazy-orbit", trace=True)
    assert out["correct"] is True
    assert out["metrics"] == {} and "breakdown" not in out


def test_without_a_card_the_run_fails_and_prints_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present: the run would go on")
    p = subprocess.run([sys.executable, "-m", "gsbench.run", "--workload",
                        "bonsai.serve-orbit", "--seed", str(tiny.SEED), "--seconds", "1",
                        "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_no_jax_after_import_and_rehearsal():
    code = ("import sys, json; import gsbench.run; from gsbench.tests import tiny; "
            "tiny.rehearse('bonsai.serve-orbit'); from gsbench import harness; "
            "print(json.dumps(harness.forbidden_modules(sys.modules)))")
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compare_the_top_level_name_whole():
    assert harness.forbidden_modules(["jax.numpy", "gsjax", "gsjax.render", "flax"]) == [
        "flax", "gsjax", "gsjax.render", "jax.numpy"]
    assert harness.forbidden_modules(["gsjax_torch", "gsjax_torch.render", "jaxtyping",
                                      "gsbench"]) == []
