"""gsjax_torch parity: the occupancy pre-pass (core/autotune.py) against
gsjax/core/autotune.py on the same scenes and cameras, and the bench
runner's derived caps on the garden scene.

The measuring pass is project → home layout (kernel A's plain version)
→ pair expansion (kernel B's); the port's layout and expansion are
bit-exact to gsjax's, so every count, the segment starts and the
candidate totals must be EQUAL, not close. gsjax's pass runs its Pallas
kernels A and B in interpret mode, so the scenes are small (n = 300, a
96×64 camera) and each gsjax measurement is made once per module, all
at one configuration: one compile (the camera is traced)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from conftest import make_random_scene

import gsjax
import gsjax_torch as gt
from gsjax.core import autotune as ja
from gsjax_torch.bench import run as trun
from gsjax_torch.core import autotune as ta

torch.set_num_threads(2)

_FIELDS = ("means", "log_scales", "quats", "sh", "opacity_logits")
CAM = dict(fx=80.0, fy=80.0, width=96, height=64)
# the fat scene's budgets (tests/test_torch_train.py:53; on the thin
# scene, whose footprints span one 3×3-tile block, they change nothing),
# and budgets the fat scene overflows (chip_smoke.py's overflow case)
KW = dict(fat_max_blocks=64, fat_cap=2048)
KW_OVERFLOW = dict(fat_max_blocks=4, fat_cap=8, fat_live_cap=8)
# three views of an orbit around the scene's middle, for derive_caps
POSITIONS = ((0.0, 0.0, 0.0), (0.4, -0.2, 0.3), (-0.5, 0.1, -0.2))
DERIVED = ("fat_cap", "fat_live_cap", "pair_cap", "repack_w", "repack_rows")


def _scene(name):
    """thin: test_torch_train's thin scene; fat: its fat one (footprints
    over many 3×3-tile blocks); offfrustum: the fat one with every third
    splat moved behind the camera (culled primaries: the n_live_prim
    rule)."""
    rng = np.random.default_rng(0)
    if name == "thin":
        return make_random_scene(rng, n=300, sh_degree=1, spread=1.2, z_range=(3.0, 8.0))
    g = make_random_scene(rng, n=300, sh_degree=1, spread=1.0, z_range=(2.0, 6.0))
    g = dataclasses.replace(g, log_scales=g.log_scales + 2.0)
    if name == "offfrustum":
        means = np.asarray(g.means).copy()
        means[::3, 2] *= -1.0
        g = dataclasses.replace(g, means=means)
    return g


def to_torch(g):
    return gt.Gaussians.from_numpy(*(np.asarray(getattr(g, f)) for f in _FIELDS),
                                   device="cpu")


def _cams(positions):
    return ([gsjax.Camera.create(position=p, **CAM) for p in positions],
            [gt.Camera.create(position=p, **CAM, device="cpu") for p in positions])


@pytest.fixture(scope="module")
def ref():
    """gsjax's measure_occupancy of each scene at the first camera and of
    the fat scene at the three cameras: one compile."""
    cams, _ = _cams(POSITIONS)
    cfg = gsjax.RenderConfig(backend="stream", chunk=32, **KW)
    out = {name: ja.measure_occupancy(_scene(name), cams[0], cfg)
           for name in ("thin", "fat", "offfrustum")}
    out["orbit"] = [out["fat"]] + [ja.measure_occupancy(_scene("fat"), c, cfg)
                                   for c in cams[1:]]
    return out


def _assert_same(mt, mj):
    assert sorted(mt) == sorted(mj)
    for k, v in mj.items():
        if isinstance(v, np.ndarray):
            assert mt[k].dtype == np.int64 and v.shape == mt[k].shape, k
            np.testing.assert_array_equal(mt[k], v, k)
        else:
            assert type(mt[k]) is int and mt[k] == v, (k, mt[k], v)


@pytest.mark.parametrize("name", ["thin", "fat", "offfrustum"])
def test_measure_occupancy_matches_gsjax(ref, name):
    _, cams = _cams(POSITIONS)
    mt = ta.measure_occupancy(to_torch(_scene(name)), cams[0], gt.RenderConfig(chunk=32, **KW))
    _assert_same(mt, ref[name])
    assert mt["n_fat_overflow"] == 0 and mt["n_pairs"] > 0
    if name != "thin":
        assert mt["n_copies"] > 0 and mt["n_valid"] > mt["n_live_prim"]
    if name == "offfrustum":  # a third culled: n_live_prim, not n, is the base
        assert mt["n_live_prim"] <= 200 < mt["n"]


def test_derive_caps_over_a_camera_list_matches_gsjax(ref):
    camsj, camst = _cams(POSITIONS)
    cfgj = gsjax.RenderConfig(backend="stream", chunk=32, **KW)
    cfgt = gt.RenderConfig(chunk=32, **KW)
    dj = ja.derive_caps(_scene("fat"), camsj, cfgj, ms=ref["orbit"])
    g = to_torch(_scene("fat"))
    dt = ta.derive_caps(g, camst, cfgt)
    for f in DERIVED:
        assert getattr(dt, f) == getattr(dj, f), f
    # the worst view sets the caps: three views, not one
    assert dt != ta.derive_caps(g, camst[0], cfgt)
    # the TPU band-scratch fields pass through; everything else is cfgt's
    assert dataclasses.replace(dt, **{f: getattr(cfgt, f) for f in DERIVED}) == cfgt
    # the measurements passed back in give the same caps
    ms = [ta.measure_occupancy(g, c, cfgt) for c in camst]
    assert ta.derive_caps(g, None, cfgt, ms=ms) == dt


def test_derive_caps_raises_where_gsjax_does():
    """Base fat budgets the measuring pass overflows: the port's derive_caps
    raises, and gsjax's raises on the same measurement (its arithmetic
    half, ms=, so no second gsjax compile)."""
    _, cams = _cams(POSITIONS)
    g = to_torch(_scene("fat"))
    cfgt = gt.RenderConfig(chunk=32, **KW_OVERFLOW)
    m = ta.measure_occupancy(g, cams[0], cfgt)
    assert m["n_fat_overflow"] > 0
    with pytest.raises(ValueError, match="overflowed the base fat budgets"):
        ta.derive_caps(g, cams[0], cfgt)
    cfgj = gsjax.RenderConfig(backend="stream", chunk=32, **KW_OVERFLOW)
    with pytest.raises(ValueError, match="overflowed the base fat budgets"):
        ja.derive_caps(_scene("fat"), None, cfgj, ms=[m])


def test_bench_runner_garden_on_the_cpu(capsys):
    """bench.run --scene garden: garden_like at SH degree 2, caps derived
    over the run's views (its splats are large for n = 2000, so the
    runner's base grows to the measured copy demand), the lazy orbit
    with overflow 0 at every resort (at 160×96: the CPU's plain blend)."""
    assert trun.main(["--quick", "--scene", "garden", "--n", "2000", "--mode", "orbit",
                      "--views", "2", "--steps-per-view", "2", "--width", "160",
                      "--height", "96", "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["scene"] == "garden" and line["mode"] == "orbit"
    assert line["resorts"] == 2 and line["device"] == "cpu" and line["peak_gib"] is None
    assert "# autotune " in err and "fat_cap=" in err
    assert "# overflow over 2 resort(s): 0 (must be 0)" in err
    assert line["final_loss"] <= line["loss0"]
