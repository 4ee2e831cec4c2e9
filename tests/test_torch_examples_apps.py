"""gsjax_torch parity: the example apps (gsjax_torch/examples/) against
the reference examples (examples/*.py) and gsjax's functions they call,
at the test budget (test_torch_examples_common.py): the demo scene, the
viewer's orbit, the loaders by extension and the .splat written back, the
.ply → .splat converter, the scene edits, the camera JSON round trip,
and the budgets — the reference examples' scene-scaled ones drop fat
copies, sized_config's drop nothing.

Frames are compared as the floats run() returns (not the PNGs, whose
8-bit rounding may flip a value on a boundary) within 5e-6 of gsjax's
jitted render (XLA's fusion moves its image by up to ~3e-6)."""

import json
import os

import numpy as np
import pytest
import torch

import gsjax
import gsjax_torch as gt
from gsjax.camera.orbit import OrbitCamera as j_OrbitCamera
from gsjax.core import transforms as j_transforms
from gsjax.io.ply import save_ply as j_save_ply
from gsjax_torch.core.autotune import derive_caps, measure_occupancy
from gsjax_torch.examples import (_common, camera_updates, file_loader, ply_converter,
                                  scene_transformations, simple_viewer)
from gsjax_torch.examples.simple_viewer import ORBIT
from gsjax_torch.render.homesort import resolve_fat_caps
from gsjax_torch.utils.image import read_png, to_uint8
from test_qply import _build_qply

from test_torch_examples_common import (FX_VIEW, H, J_CFG, N, W, assert_splat_close,
                                        j_examples_common, j_look_at, j_render)
from test_torch_io_common import assert_activated

torch.set_num_threads(2)

TOL = 5e-6
ZERO = dict.fromkeys(_common.OVERFLOW_KEYS, 0)
VIEW = dict(device="cpu", n=N, width=W, height=H, fx=FX_VIEW)


@pytest.fixture(scope="module")
def jdemo():
    """The reference examples' demo scene (n = 400, SH 1), and that scene
    written by gsjax as .ply (its raw floats), so an app reading it starts
    from gsjax's bits."""
    return j_examples_common().demo_scene(n=N)


@pytest.fixture
def jdemo_ply(jdemo, tmp_path):
    path = tmp_path / "demo.ply"
    j_save_ply(jdemo, path)
    return path


@pytest.mark.parametrize("n,sh_degree", [(N, 1), (N, 0)])
def test_demo_scene_matches_examples_common(n, sh_degree):
    """examples/_common.py's draws, field for field: means, quats and SH
    bit-equal, the logs of the activated scales and opacities within
    their ulps (torch's log is correctly rounded, XLA's CPU log may sit
    an ulp off; test_torch_io's rule)."""
    gj = j_examples_common().demo_scene(n=n, sh_degree=sh_degree)
    gp = _common.demo_scene(n=n, sh_degree=sh_degree, device="cpu")
    assert gp.n == n and gp.sh_degree == sh_degree
    assert_activated(gp, gj)


def test_simple_viewer_matches_render_orbit(jdemo, jdemo_ply, tmp_path):
    """simple_viewer's 8 orbit frames of the reference's demo scene (read
    from gsjax's .ply: a log-scale an ulp apart may move a pixel's α
    across α_min) within 5e-6 of gsjax's render_orbit's (its cameras,
    rendered op by op); 8 PNGs of those frames; every overflow counter 0
    over the 8 renders."""
    res = simple_viewer.run(jdemo_ply, out=tmp_path, **VIEW)
    cams = j_OrbitCamera(**ORBIT).trajectory(8, width=W, height=H, fx=FX_VIEW, fy=FX_VIEW)
    jf = np.stack([j_render(jdemo, c) for c in cams])  # render_orbit's frames, op by op
    assert res["frames"].shape == (8, H, W, 3)
    assert float(np.abs(res["frames"] - jf).max()) <= TOL
    assert res["overflow"] == ZERO and res["renders"] == 8
    pngs = sorted(os.listdir(tmp_path / "simple_viewer"))
    assert pngs == [f"frame_{i:04d}.png" for i in range(8)]
    np.testing.assert_array_equal(read_png(tmp_path / "simple_viewer" / pngs[3]),
                                  to_uint8(res["frames"][3]))
    assert not np.array_equal(res["frames"][0], res["frames"][4])  # the orbit moves


def test_file_loader_by_extension(jdemo, jdemo_ply, tmp_path):
    """file_loader on a .splat, a .ply and a quantized .qply written by
    gsjax: each frame within 5e-6 of gsjax's render of gsjax's load of
    the file, scene_out.splat equal to gsjax's save_splat of it (as
    assert_splat_close reads equal); any other extension raises
    ValueError, as the reference's load_any does."""
    # a codebook scene the span budget clamps nowhere in this view, so
    # gsjax's span-budget render is its exact one (seed 0's clamps a splat)
    qbuf, _ = _build_qply(np.random.default_rng(1), counts=(40, 30, 20, 10))
    files = {"splat": tmp_path / "demo.splat", "ply": jdemo_ply, "qply": tmp_path / "q.qply"}
    gsjax.save_splat(jdemo, files["splat"])
    files["qply"].write_bytes(qbuf)
    loads = {"splat": gsjax.load_splat, "ply": lambda p: gsjax.load_ply(p, use_shs=True),
             "qply": lambda p: gsjax.load_ply(p, quantized=True)}
    for fmt, path in files.items():
        out = tmp_path / fmt
        res = file_loader.run(path, out=out, **VIEW)
        gj = loads[fmt](path)
        assert res["n"] == gj.n and res["sh"] == gj.sh.shape[1], fmt
        d = float(np.abs(res["frame"] - j_render(gj, j_look_at())).max())
        assert d <= TOL, (fmt, d)
        assert res["overflow"] == ZERO, fmt
        assert_splat_close((out / "scene_out.splat").read_bytes(), gsjax.save_splat(gj))
    bad = tmp_path / "scene.obj"
    bad.write_bytes(b"")
    with pytest.raises(ValueError, match="unsupported scene format"):
        file_loader.run(bad, out=tmp_path / "bad", **VIEW)
    assert not (tmp_path / "bad").exists()


def test_ply_converter_matches_gsjax(jdemo_ply, tmp_path):
    """The .ply gsjax wrote converts to the .splat gsjax's converter
    writes; with no input the demo scene of 500 splats goes through
    demo.ply (bit-equal on reload: .ply stores the raw floats) into
    converted.splat, which is save_splat of that scene byte for byte."""
    res = ply_converter.run(jdemo_ply, device="cpu", out=tmp_path / "given")
    assert res["n"] == N and res["renders"] == 0 and res["overflow"] == ZERO
    assert_splat_close(open(res["out"], "rb").read(),
                       gsjax.save_splat(gsjax.load_ply(jdemo_ply)))
    res = ply_converter.run(device="cpu", out=tmp_path / "demo")
    g = _common.demo_scene(n=500, device="cpu")
    back = gt.load_ply(res["src"], device="cpu")
    for f in ("means", "log_scales", "quats", "sh", "opacity_logits"):
        assert torch.equal(getattr(back, f), getattr(g, f)), f
    assert open(res["out"], "rb").read() == gt.save_splat(g)


def test_scene_transformations_match_gsjax(jdemo, jdemo_ply, tmp_path):
    """The edits (rotate 30° about +y, translate, scale 0.8, limit_box) on
    gsjax's demo scene: the before and after frames within 5e-6 of
    gsjax's renders, transformed.splat's floats within 1e-6 of each
    column's peak of gsjax's (torch and XLA order the rotation's sums
    apart, and a coordinate near 0 keeps the sum's rounding) and its u8
    columns within one step."""
    res = scene_transformations.run(jdemo_ply, out=tmp_path, **VIEW)
    half = np.deg2rad(30.0) / 2
    g2 = j_transforms.rotate(jdemo, (np.cos(half), 0.0, np.sin(half), 0.0))
    g2 = j_transforms.translate(g2, (0.3, 0.0, 0.0))
    g2 = j_transforms.scale(g2, 0.8)
    g2 = j_transforms.limit_box(g2, -2.0, 2.0, -2.0, 2.0, 1.0, 7.0)
    cam = j_look_at()
    assert float(np.abs(res["before"] - j_render(jdemo, cam)).max()) <= TOL
    assert float(np.abs(res["after"] - j_render(g2, cam)).max()) <= TOL
    assert res["overflow"] == ZERO and res["renders"] == 2
    rp = np.frombuffer((tmp_path / "transformed.splat").read_bytes(), np.uint8).reshape(-1, 32)
    rj = np.frombuffer(gsjax.save_splat(g2), np.uint8).reshape(-1, 32)
    fp, fj = (r[:, :24].copy().view(np.float32) for r in (rp, rj))
    assert (np.abs(fp - fj) <= 1e-6 * np.abs(fj).max(axis=0)).all()
    assert np.abs(rp[:, 24:].astype(int) - rj[:, 24:].astype(int)).max() <= 1


def test_camera_updates_match_gsjax(jdemo, jdemo_ply, tmp_path):
    """camera.json holds gsjax's camera_to_json of both poses, value for
    value; both frames within 5e-6 of gsjax's renders."""
    res = camera_updates.run(jdemo_ply, out=tmp_path, **VIEW)
    cam = j_look_at()
    data = gsjax.camera_to_json(cam)
    data["position"] = [1.5, -0.5, -0.5]
    cam2 = gsjax.camera_from_json(data)
    want = [gsjax.camera_to_json(cam), gsjax.camera_to_json(cam2)]
    assert json.loads((tmp_path / "camera.json").read_text()) == want == res["cameras"]
    for frame, c in zip(res["frames"], (cam, cam2)):
        assert float(np.abs(frame - j_render(jdemo, c)).max()) <= TOL
    assert res["overflow"] == ZERO and res["renders"] == 2


def test_reference_budgets_drop_fat_copies_sized_config_drops_none():
    """The reference examples' own configuration (RenderConfig(backend=
    "auto"), the demo scene of 4,000 splats at 640×480, fx 500) drops
    fat copies: the scene-scaled live cap n + n//4 = 5,000 (gsjax's
    resolve_fat_caps' too) against 5,858 live copies. gsjax's render of
    it, which costs ~32 s on the CPU (its layout kernels interpreted),
    gave n_fat_overflow 852 and 39,085 pairs when it was measured; the port
    gives the same. sized_config over that view drops nothing: its
    budgets are derive_caps' measured at the ceiling, the render has
    41,876 pairs (the measured demand) and every counter 0."""
    from gsjax.render.homesort import resolve_fat_caps as j_resolve_fat_caps

    g = _common.demo_scene(device="cpu")
    cam = gt.Camera.look_at(_common.EYE, _common.AT, fx=500.0, fy=500.0, width=640,
                            height=480, device="cpu")
    cfg = gt.RenderConfig(backend="auto")
    assert resolve_fat_caps(4000, cfg) == j_resolve_fat_caps(4000, J_CFG) == (8192, 5000)
    m = measure_occupancy(g, cam, cfg)  # the render's counts (its layout and pairs)
    assert m["n_fat_overflow"] == 852 and m["n_pairs"] == 39085
    sized, demand = _common.sized_config(g, [cam], backend="auto")
    assert demand == {"copies": 5858, "copy_slots": 7344, "pairs": 41876, "passes": 2}
    # measured at smaller tables than the ceiling, counted as it counts
    ceiling = gt.RenderConfig(backend="auto", **_common.CEILING)
    assert sized == derive_caps(g, [cam], ceiling, ms=[measure_occupancy(g, cam, ceiling)])
    with torch.no_grad():
        _, aux = gt.render(g, cam, sized, return_aux=True)
    assert all(int(aux[k]) == 0 for k in _common.OVERFLOW_KEYS if k in aux)
    assert int(aux["n_pairs"]) == 41876
