"""gsjax_torch: kernel D's plain version against autograd of the forward,
fit, checkpoints, the card defaults and the bench runner on the CPU."""

import inspect
import json

import numpy as np
import pytest
import torch

from conftest import make_random_scene

import gsjax_torch as gt
from gsjax_torch import train as tt
from gsjax_torch.bench import run as trun
from gsjax_torch.bench import synth as tsynth
from gsjax_torch.render import homesort as ths
from gsjax_torch.render.project import project

from test_torch_train_common import CAM, KW, W, _FIELDS, _scene, to_torch


@pytest.mark.parametrize("name", ["thin", "fat", "fat_eps0.05", "fat_eps0.2"])
def test_stream_backward_matches_autograd_of_forward(name):
    """Kernel D's plain version (the hand-derived VJP, replayed in the
    forward's order) against autograd through kernel C's plain version,
    with random cotangents on both outputs: the transmittance's cotangent
    ct_T is 0 in every render loss with the default black background, so
    only this test reaches the ct_T·T_act term. The fat scene runs also
    with transmittance_eps raised to 0.05 and 0.2, where many pixels end
    near T ≈ eps."""
    from gsjax_torch.render.binning import build_tile_bins
    from gsjax_torch.render.composite import att_table, clipped_pair_stream
    from gsjax_torch.render.stream import stream_backward, stream_forward_plain

    scene, _, eps = name.partition("_eps")
    cam = gt.Camera.create(**CAM, device="cpu")
    cfg = gt.RenderConfig(chunk=32, **KW,
                          **({"transmittance_eps": float(eps)} if eps else {}))
    with torch.no_grad():
        ph, layout = ths.build_home_layout(project(to_torch(_scene(scene)[0]), cam, cfg),
                                           cam, cfg)
        bins = build_tile_bins(ph, cam, cfg, anchor="home", layout=layout)
    pid, starts, _ = clipped_pair_stream(bins, cfg)
    tiles_x = cfg.tiles_x(W)
    att = att_table(ph).requires_grad_()
    out = stream_forward_plain(att, pid, starts, 0, tiles_x, cfg)
    if eps:  # many pixels terminate
        assert float((out[:, 4] < cfg.transmittance_eps).float().mean()) > 0.3
    rng = np.random.default_rng(4)
    ct_img = torch.from_numpy(rng.normal(size=(out.shape[0], 256, 3)).astype(np.float32))
    ct_T = torch.from_numpy(rng.normal(size=(out.shape[0], 256)).astype(np.float32))
    (d_auto,) = torch.autograd.grad(
        (out[:, 0:3].transpose(1, 2) * ct_img).sum() + (out[:, 3] * ct_T).sum(), att)
    d = stream_backward(att.detach(), pid, starts, out.detach(), ct_img, ct_T, 0,
                        tiles_x, cfg)
    peak = d_auto.abs().amax(dim=0) + 1e-12
    rel = ((d - d_auto).abs() / peak).numpy()
    assert (d_auto.abs().amax(dim=0) > 0).all()
    assert np.percentile(rel, 99.9) < 1e-4, np.percentile(rel, 99.9, axis=0)
    assert rel.max() < 1e-2, rel.max(axis=0)


def test_fit_recovers_perturbation():
    """tests/test_train.py::test_fit_recovers_perturbation on the port."""
    g = to_torch(make_random_scene(np.random.default_rng(0), n=60))
    cams = [gt.Camera.create(fx=90, fy=90, width=64, height=48, device="cpu")]
    cfg = gt.RenderConfig(chunk=32)
    with torch.no_grad():
        targets = [gt.render(g, c, cfg) for c in cams]
        g.means += 0.02
    state, losses = tt.fit(g, cams, targets, cfg, steps=60,
                           optimizer=torch.optim.Adam(g.parameters(), 3e-4))
    assert state.step == 60 and state.gaussians is g
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])
    # with a band mesh (3 bands of one tile row) the step's loss is the
    # same mean over the image (whole tiles)
    from gsjax_torch.parallel.mesh import make_mesh

    with torch.no_grad():
        loss = float(torch.mean((gt.render(g, cams[0], cfg) - targets[0]) ** 2))
    _, l_mesh = tt.fit(g, cams, targets, cfg, steps=1, mesh=make_mesh(3, "cpu"),
                       optimizer=torch.optim.Adam(g.parameters(), 3e-4))
    assert l_mesh[0] == pytest.approx(loss, rel=1e-5)


def test_checkpoint_roundtrip(tmp_path):
    g = to_torch(make_random_scene(np.random.default_rng(0), n=20))
    cam = gt.Camera.create(fx=90, fy=90, width=32, height=32, device="cpu")
    state, _ = tt.fit(g, [cam], [np.zeros((32, 32, 3), np.float32)],
                      gt.RenderConfig(chunk=32), steps=2)
    state.step = 7
    tt.save_checkpoint(tmp_path / "ckpt.pt", state)
    g2 = to_torch(make_random_scene(np.random.default_rng(5), n=20))
    restored = tt.load_checkpoint(tmp_path / "ckpt.pt",
                                  tt.TrainState(g2, tt.default_optimizer(g2)))
    assert restored.step == 7 and restored.gaussians is g2
    for f in _FIELDS:
        assert torch.equal(getattr(g2, f), getattr(g, f)), f
    sa, sb = state.optimizer.state_dict(), restored.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for k, st in sa["state"].items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(st[name], sb["state"][k][name]), (k, name)


def test_entry_points_default_to_the_card():
    for fn in (gt.Gaussians.from_numpy, gt.Gaussians.from_activated,
               gt.Camera.create, tsynth.bonsai_like, tsynth.garden_like,
               tsynth.bench_camera, trun.orbit_cameras):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    # look_at and the orbit pass `device` through to Camera.create
    cams = gt.OrbitCamera().trajectory(2, device="cpu")
    assert all(c.position.device.type == "cpu" for c in cams)
    if not torch.cuda.is_available():  # no silent CPU fallback
        with pytest.raises((RuntimeError, AssertionError)):
            gt.Camera.look_at((0.0, 0.0, -4.0), (0.0, 0.0, 0.0))


def test_bench_runner_on_the_cpu(capsys):
    import bench  # the reference runner's perturb: the same draws

    gj = make_random_scene(np.random.default_rng(3), n=50)
    pj, pt = bench.perturb(gj), trun.perturb(to_torch(gj))
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(pt, f).detach().numpy(),
                                      np.asarray(getattr(pj, f)), f)

    assert trun.main(["--quick", "--n", "2000", "--width", "160", "--height", "96",
                      "--mode", "fixed", "--frames", "2", "--device", "cpu"]) == 0
    out, _ = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["metric"] == "1080p_fwd_bwd_ms_per_frame" and line["unit"] == "ms"
    assert line["mode"] == "fixed" and line["frames"] == 2
    assert line["device"] == "cpu" and "vs_baseline" not in line
    assert line["loss0"] > 0 and line["value"] > 0
    for mode in ("orbit", "fixed-lazy"):  # the lazy modes: stream, training only
        for flag in (["--backend", "pallas"], ["--forward-only"]):
            with pytest.raises(SystemExit, match="stream backend"):
                trun.main(["--mode", mode, "--device", "cpu", *flag])
