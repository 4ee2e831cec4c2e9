"""gsjax_torch parity: the viewer loop's pieces against gsjax's — the orbit
controls (camera/controls.py) on a recorded event stream, camera JSON
(camera/json_io.py), PNG reading, the render passes (render/passes.py),
render(passes=...) and render_trajectory(fade_in=True).

Controls and camera JSON are numpy on the host in both packages: states,
cameras and dicts equal bit for bit. The passes are held to gsjax's on
the same projected splats within 2 ulps of each field (true division by
tensors in the port, as in gsjax's eager ops); renders within 5e-6 of
gsjax's jitted xla backend: XLA's fusion moves gsjax's own jitted image
by up to 2.8e-6 from its eager ops on these scenes, and the port's is
within 2e-7 of the eager one (measured; eager renders cost ~10 s each)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_random_scene

import gsjax
import gsjax_torch as gt
from gsjax.camera import controls as jctl
from gsjax.camera import json_io as jjson
from gsjax.render import passes as jpasses
from gsjax.render.project import ProjectedSplats as JProjected
from gsjax.utils.image import write_png as j_write_png
from gsjax.viewer import render_trajectory as j_render_trajectory
from gsjax_torch import controls as tctl
from gsjax_torch.render import passes as tpasses
from gsjax_torch.render.project import project as t_project
from gsjax_torch.utils.image import read_png, to_uint8, write_png

torch.set_num_threads(2)

_FIELDS = ("means", "log_scales", "quats", "sh", "opacity_logits")
_LEAVES = ("position", "quat", "fx", "fy")
W, H = 64, 48
# far = 8: the depth fade's normalised depth spans the scene (at the
# default far = 1000 every splat's fade completes at value ~0.1)
CAM = dict(fx=60.0, fy=60.0, width=W, height=H, far=8.0)
XLA = dict(backend="xla", tile_list_cap=128, chunk=32)


def _events(m):
    """A session of every event type (m: the package's controls module),
    frame by frame; None marks a set_camera freeze."""
    return [
        [m.MouseDown(10.0, 20.0)], [m.MouseMove(40.0, 30.0)], [m.MouseMove(55.0, 12.0)],
        [m.MouseUp()], [m.MouseDown(30.0, 30.0, button=2)], [m.MouseMove(36.0, 41.0)],
        [m.MouseUp()], [m.Wheel(-120.0)], [m.Wheel(45.0)], [m.KeyDown("KeyW")], [],
        [m.KeyUp("KeyW")], [m.KeyDown("ArrowLeft"), m.KeyDown("KeyE")],
        [m.KeyUp("ArrowLeft"), m.KeyUp("KeyE")], [m.TouchStart(((5.0, 5.0),))],
        [m.TouchMove(((9.0, 3.0),))], [m.TouchEnd()],
        [m.TouchStart(((10.0, 10.0), (30.0, 40.0)))],
        [m.TouchMove(((12.0, 8.0), (34.0, 47.0)))], [m.TouchEnd()],
        [m.SetCameraTarget((0.3, -0.1, 0.4))], [], [None], [], [m.MouseDown(0.0, 0.0)],
        [m.MouseMove(0.0, 0.0)], [m.MouseMove(3.0, 0.0)], [m.MouseUp()], [], [],
    ]


def _replay(m, cam_kw):
    """(states, cameras) after each frame's events and update."""
    s, p = m.OrbitState(), m.OrbitParams(dampening=0.2)
    states, cams = [], []
    for frame in _events(m):
        for e in frame:
            s = m.set_camera(s) if e is None else m.apply_event(s, e, p)
        s = m.update(s, p)
        states.append(dataclasses.asdict(s))
        cams.append(m.to_camera(s, **cam_kw))
    return states, cams


def _cam_arrays(c):
    return [np.array(getattr(c, f), np.float32) for f in _LEAVES] + \
        [c.width, c.height, c.near, c.far]


def test_event_replay_matches_gsjax():
    """tests/test_controls.py's replay (test_event_stream_replay_
    deterministic_and_camera_export) extended to every event type, a
    SetCameraTarget and a set_camera freeze: the port's OrbitState after
    every frame equals gsjax's, and so do the cameras, bit for bit."""
    kw = dict(fx=500.0, fy=510.0, width=320, height=240)
    sj, cj = _replay(jctl, kw)
    st, ct = _replay(tctl, dict(kw, device="cpu"))
    assert st == sj
    frozen = [i for i, s in enumerate(st) if s["static_cam"]]
    assert frozen and len({json.dumps(st[i]["position"]) for i in frozen}) == 1
    for a, b in zip(ct, cj):
        for x, y in zip(_cam_arrays(a), _cam_arrays(b)):
            np.testing.assert_array_equal(x, y)
    assert ct[0].position.device.type == "cpu"


def test_camera_json_quat_form_matches_gsjax():
    """camera_to_json's dict equals gsjax's; the dict read back (as a
    string, as a parsed dict) is gsjax's camera bit for bit."""
    kw = dict(position=(1.0, 2.0, 3.0), quat=(0.9, 0.1, 0.3, -0.2), fx=700.0, fy=710.0,
              width=640, height=480)
    d = gt.camera_to_json(gt.Camera.create(**kw, device="cpu"), id=7, img_name="r_0")
    assert d == jjson.camera_to_json(gsjax.Camera.create(**kw), id=7, img_name="r_0")
    for data in (json.dumps(d), d):
        cam = gt.camera_from_json(data, device="cpu")
        for x, y in zip(_cam_arrays(cam), _cam_arrays(jjson.camera_from_json(data))):
            np.testing.assert_array_equal(x, y)


def test_camera_json_matrix_form_matches_gsjax():
    """COLMAP's form (a 3×3 rotation, a flat position) through the port's
    rotmat_to_quat, and a cameras.json list, equal to gsjax's."""
    R = np.asarray(gsjax.Camera.create(quat=(0.8, 0.2, -0.4, 0.4)).rotation_c2w())
    d = {"position": [0.5, -1.0, 2.0], "rotation": R.tolist(), "fx": 1000, "fy": 1000,
         "width": 100, "height": 80}
    lst = json.dumps([d, dict(d, position={"x": 1.0, "y": 0.0, "z": -2.0})])
    got, want = gt.cameras_from_json(lst, device="cpu"), jjson.cameras_from_json(lst)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        for x, y in zip(_cam_arrays(a), _cam_arrays(b)):
            np.testing.assert_array_equal(x, y)


def test_read_png_roundtrip(tmp_path):
    """read_png(write_png(x)) is x in 8 bits; the port reads gsjax's file."""
    img = np.random.default_rng(3).uniform(0, 1, (33, 47, 3)).astype(np.float32)
    write_png(tmp_path / "t.png", img)
    j_write_png(tmp_path / "j.png", img)
    np.testing.assert_array_equal(read_png(tmp_path / "t.png"), to_uint8(img))
    np.testing.assert_array_equal(read_png(tmp_path / "j.png"), to_uint8(img))


def _scene():
    rng = np.random.default_rng(5)
    return make_random_scene(rng, n=150, sh_degree=1, spread=0.9, z_range=(3.0, 9.0))


@pytest.mark.parametrize("name", ["depth_fade", "splat_scale"])
def test_passes_match_gsjax(name):
    """Each pass on the same projected splats (the port's projection, in
    both packages): every field within 2 ulps of gsjax's, the same valid
    mask; the fade front cuts through the scene."""
    g = _scene()
    gp = gt.Gaussians.from_numpy(*(np.asarray(getattr(g, f)) for f in _FIELDS), device="cpu")
    ct = gt.Camera.create(**CAM, device="cpu")
    with torch.no_grad():
        pt = t_project(gp, ct, gt.RenderConfig())
    pj = JProjected(**{f.name: jnp.asarray(getattr(pt, f.name).numpy())
                       for f in dataclasses.fields(pt)})
    make = {"depth_fade": lambda m: m.depth_fade(0.05), "splat_scale": lambda m: m.splat_scale(1.7)}
    qt = make[name](tpasses)(pt, ct, gt.RenderConfig())
    qj = make[name](jpasses)(pj, gsjax.Camera.create(**CAM), gsjax.RenderConfig())
    np.testing.assert_array_equal(qt.valid.numpy(), np.asarray(qj.valid))
    for f in ("conic", "radius"):
        np.testing.assert_array_max_ulp(getattr(qt, f).numpy(), np.asarray(getattr(qj, f)), 2)
    if name == "depth_fade":
        s = qt.radius[pt.valid] / pt.radius[pt.valid]
        assert bool(((s > 0) & (s < 1)).any())


def test_render_passes_match_gsjax():
    """render(passes=[depth_fade, splat_scale]) through the xla backend:
    within 5e-6 of gsjax's image."""
    g = _scene()
    gp = gt.Gaussians.from_numpy(*(np.asarray(getattr(g, f)) for f in _FIELDS), device="cpu")
    passes = lambda m: [m.depth_fade(0.05), m.splat_scale(1.3)]
    with torch.no_grad():
        img = gt.render(gp, gt.Camera.create(**CAM, device="cpu"), gt.RenderConfig(**XLA),
                        passes=passes(tpasses))
        plain = gt.render(gp, gt.Camera.create(**CAM, device="cpu"), gt.RenderConfig(**XLA))
    want = jax.jit(lambda g, c: gsjax.render(g, c, gsjax.RenderConfig(**XLA),
                                             passes=passes(jpasses)))(
        g, gsjax.Camera.create(**CAM))
    assert np.abs(img.numpy() - np.asarray(want)).max() <= 5e-6
    assert float((img - plain).abs().max()) > 1e-2  # the passes changed the frame


def test_render_trajectory_fade_matches_gsjax(tmp_path):
    """render_trajectory(fade_in=True): the fade advances by speed·0.01 a
    frame (0.4, 0.8, 1.0 here) and the frames after it reaches 1 carry no
    pass. Each frame within 5e-6 of gsjax's render with that frame's own
    fade value; the PNGs written. gsjax's render_trajectory keys its jit
    cache by (width, height, any pass), so every frame with a pass renders
    the first frame's fade value (gsjax/viewer.py:45-47): its frame 2 is
    its fade-0.4 render, a reference fault the port does not copy."""
    g = _scene()
    gp = gt.Gaussians.from_numpy(*(np.asarray(getattr(g, f)) for f in _FIELDS), device="cpu")
    kw = dict(fx=60.0, fy=60.0, width=W, height=H, far=8.0)
    orbit = dict(radius=6.0, target=(0.0, 0.0, 6.0))
    cams_j = gsjax.OrbitCamera(**orbit).trajectory(4, alpha_end=0.4, **kw)
    cams_t = gt.OrbitCamera(**orbit).trajectory(4, alpha_end=0.4, **kw, device="cpu")
    frames = gt.render_trajectory(gp, cams_t, gt.RenderConfig(**XLA), out_dir=tmp_path,
                                  fade_in=True, fade_speed=40.0)
    cfg = gsjax.RenderConfig(**XLA)
    faded = jax.jit(lambda g, c, v: gsjax.render(g, c, cfg, passes=(jpasses.depth_fade(v),)))
    # at fade 1 every footprint's scale is exactly 1: the pass changes no
    # bit, so gsjax's fade-1 render stands for its render with no pass
    want = [faded(g, c, v) for c, v in zip(cams_j, (0.4, 0.8, 1.0, 1.0))]
    assert frames.shape == (4, H, W, 3)
    for i, w in enumerate(want):
        assert np.abs(frames[i] - np.asarray(w)).max() <= 5e-6, i
    assert np.abs(frames[0] - frames[3]).max() > 1e-2
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"frame_{i:04d}.png" for i in range(4)]
    # gsjax's own trajectory over the frames with a pass: the first frame's
    # fade value throughout
    traj = j_render_trajectory(g, cams_j[:3], cfg, fade_in=True, fade_speed=40.0)
    assert np.abs(traj[0] - frames[0]).max() <= 5e-6
    assert np.abs(traj[2] - np.asarray(faded(g, cams_j[2], 0.4))).max() <= 1e-6
    assert np.abs(traj[2] - frames[2]).max() > 1e-2
