"""BENCHMARK.json against its contract's form, and every configuration,
traffic mix, limits file and per-layer metric it names found by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from gsbench import harness
from gsbench.inputs import cameras, scenes

MAN = harness.manifest()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
PATH = re.compile(r"[A-Za-z0-9_./\-]{1,200}\Z")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_form():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= len(MAN["paths"]) <= 16 and all(PATH.match(p) for p in MAN["paths"])
    assert all(not p.startswith("/") and ".." not in p.split("/") for p in MAN["paths"])
    assert 1 <= len(MAN["command"]) <= 32 and all(_line(w) for w in MAN["command"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN).encode()) <= 64 * 1024


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries_keys_names_and_units(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    for e in MAN[kind]:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e and kind in ("configs", "workloads", "per_layer"):
                assert _line(e[k]), (k, e[k])


def test_cells_configs_and_metrics_fit_together():
    configs = {c["name"] for c in MAN["configs"]}
    cells = {w["name"] for w in MAN["workloads"]}
    assert {w["config"] for w in MAN["workloads"]} == configs
    assert len({(w["config"], w["traffic"]) for w in MAN["workloads"]}) == len(cells)
    assert all(w["chips"] in (1, 4) and NAME.match(w["traffic"]) for w in MAN["workloads"])
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    layers = {}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for w in m.get("workloads", cells):
            assert w in cells and w in e2e[m["moves"]].get("workloads", cells)
        layers.setdefault(m["layer"], set()).add(m["name"])
    for w in cells:
        reported = [m for m in MAN["end_to_end"] if w in m.get("workloads", cells)]
        assert len(reported) >= 2 and any(m["name"] == "setup_s" for m in reported)
        assert any(w in m.get("workloads", cells) for m in MAN["per_layer"])


@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_every_named_file_is_found(workload):
    c = harness.cell(MAN, workload)
    conf = c["config_entry"]
    assert conf["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
    assert c["config"]["name"] == conf["name"]
    assert c["config"]["reduced"] == conf["reduced"]
    assert harness.mode(c["traffic"]["kind"]).setup
    for m in harness.metrics_for(MAN, workload, "per_layer"):
        assert callable(harness.metric_reader(m["name"]))
    assert set(c["limits"]) and all(v > 0 for v in c["limits"].values())


@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
def test_every_configs_generator_and_camera_kind_are_found(config):
    conf = harness.load_json(os.path.join(harness.ROOT, {c["name"]: c["file"]
                                                         for c in MAN["configs"]}[config]))
    assert callable(harness.module_at("inputs/scenes", conf["scene"]["generator"]).generate)
    cams = cameras.make(conf["cameras"])
    assert len(cams) == conf["cameras"]["views"]
    assert {(c["width"], c["height"]) for c in cams} == {
        (conf["cameras"]["width"], conf["cameras"]["height"])}


def test_a_new_cell_needs_only_new_files(tmp_path, monkeypatch):
    """A configuration with a scene generator and a camera kind of its own,
    a traffic mix, a limits file and a per-layer metric added as files and
    manifest entries are found with no edit."""
    root = tmp_path / "repo"
    (root / "gsbench").mkdir(parents=True)
    for sub in ("configs", "traffic", "limits", "metrics", "inputs/scenes", "inputs/cameras"):
        (root / "gsbench" / sub).mkdir(parents=True)
    (root / "gsbench/inputs/scenes/one_blob.py").write_text(
        "import torch\n"
        "def generate(n, sh_degree, seed, offset, device):\n"
        "    z = torch.zeros\n"
        "    return {'means': z(n, 3), 'log_scales': z(n, 3), 'quats': z(n, 4),\n"
        "            'sh': z(n, 1, 3), 'opacity_logits': z(n) + seed}\n")
    (root / "gsbench/inputs/cameras/front.py").write_text(
        "from gsbench.inputs.cameras import look_at\n"
        "def cameras(spec):\n"
        "    return [look_at((0, 0, -4), (0, 0, 0), 100, 100, spec['width'], spec['height'])]\n")
    man = json.loads(json.dumps(MAN))
    conf = dict(harness.load_json(os.path.join(harness.HERE, "configs", "bonsai.json")),
                name="bonsai2", scene={"generator": "one_blob", "n": 5, "sh_degree": 0,
                                       "seed_offset": 0},
                cameras={"kind": "front", "width": 32, "height": 16})
    (root / "gsbench/configs/bonsai2.json").write_text(json.dumps(conf))
    (root / "gsbench/traffic/serve_burst.json").write_text(
        json.dumps(dict(harness.load_json(os.path.join(harness.HERE, "traffic",
                                                       "serve_orbit.json")), sample_frames=2)))
    (root / "gsbench/limits/bonsai2.serve-burst.json").write_text('{"mean_abs": 1}')
    (root / "gsbench/metrics/frames_seen.serve.py").write_text(
        "def read(art):\n    return art['units']\n")
    man["configs"].append({"name": "bonsai2", "source": "x", "file": "gsbench/configs/bonsai2.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "bonsai2.serve-burst", "config": "bonsai2",
                             "traffic": "serve_burst", "chips": 1, "why": "x"})
    man["per_layer"].append({"name": "frames_seen.serve", "unit": "frames", "better": "higher",
                             "source": "program_counter", "layer": "x", "moves": "frames_per_s",
                             "workloads": ["bonsai2.serve-burst"]})
    monkeypatch.setattr(harness, "ROOT", str(root))
    monkeypatch.setattr(harness, "HERE", str(root / "gsbench"))
    c = harness.cell(man, "bonsai2.serve-burst")
    assert c["traffic"]["sample_frames"] == 2 and c["config"]["name"] == "bonsai2"
    names = [m["name"] for m in harness.metrics_for(man, "bonsai2.serve-burst", "per_layer")]
    assert names[-1] == "frames_seen.serve" and "autotune_s" in names
    assert harness.metric_reader("frames_seen.serve")({"units": 7}) == 7
    scene = scenes.make_scene(c["config"]["scene"], 3, "cpu")
    assert scene["means"].shape == (5, 3) and float(scene["opacity_logits"][0]) == 3.0
    assert [cam["width"] for cam in cameras.make(c["config"]["cameras"])] == [32]
