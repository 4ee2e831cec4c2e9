"""gsjax_torch parity: the training slice against gsjax on the CPU —
fexp's derivative, the home gather's VJP, render gradients of the stream
and flat backends (kernels D's and F's plain versions) on a thin and a
fat-splat scene, Adam
steps, fit, checkpoints, the device defaults and the bench runner.

Gradients are held to jax.grad through gsjax's plain f32 `xla` backend,
which lays out the same home rows in exact mode (so a fat splat's copy
rows reach their parent through the same segment sum), at the bounds of
tests/test_stream.py::test_stream_grads_match_xla. The gsjax side
compiles one render gradient, shared by both scenes (the same shapes
and configuration), once per module."""

import dataclasses
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import make_random_scene

import gsjax
import gsjax_torch as gt
from gsjax.render.fastmath import fexp as j_fexp
from gsjax.render.homesort import _home_gather_bwd
from gsjax.train import default_optimizer as j_default_optimizer
from gsjax_torch import train as tt
from gsjax_torch.bench import run as trun
from gsjax_torch.bench import synth as tsynth
from gsjax_torch.render import homesort as ths
from gsjax_torch.render.fastmath import fexp as t_fexp
from gsjax_torch.render.project import project

torch.set_num_threads(2)

_FIELDS = ("means", "log_scales", "quats", "sh", "opacity_logits")
W, H = 96, 64
CAM = dict(fx=80.0, fy=80.0, width=W, height=H)


def to_torch(g):
    return gt.Gaussians.from_numpy(*(np.asarray(getattr(g, f)) for f in _FIELDS),
                                   device="cpu")


# the fat scene's budgets (tests/test_stream.py's fat-splat cases); on the
# thin scene, whose footprints span one 3×3-tile block, they change nothing
KW = dict(fat_max_blocks=64, fat_cap=2048)


def _scene(name):
    """thin: test_stream_grads_match_xla's scene; fat: the same generator
    with footprints over many 3×3-tile blocks (log_scales + 2)."""
    rng = np.random.default_rng(0)
    if name == "thin":
        g = make_random_scene(rng, n=300, sh_degree=1, spread=1.2, z_range=(3.0, 8.0))
    else:
        g = make_random_scene(rng, n=300, sh_degree=1, spread=1.0, z_range=(2.0, 6.0))
        g = dataclasses.replace(g, log_scales=g.log_scales + 2.0)
    tgt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    return g, tgt


@pytest.fixture(scope="module")
def ref():
    """The jitted gsjax value-and-grad of the image loss ("vg") and, per
    scene, (g, target, loss and gradient at g, gsjax's aux counters)."""
    camj = gsjax.Camera.create(**CAM)
    cfg = gsjax.RenderConfig(backend="xla", tile_list_cap=512, chunk=32, **KW)

    def loss(g, t):
        img, aux = gsjax.render(g, camj, cfg, return_aux=True)
        ovf = {k: aux[k] for k in ("n_tile_overflow", "n_fat_overflow")}
        return jnp.mean((img - t) ** 2), ovf

    out = {"vg": jax.jit(jax.value_and_grad(loss, has_aux=True))}
    for name in ("thin", "fat"):
        g, tgt = _scene(name)
        (val, ovf), grads = out["vg"](g, jnp.asarray(tgt))
        out[name] = dict(g=g, tgt=tgt, loss=float(val), grads=grads,
                         ovf={k: int(v) for k, v in ovf.items()})
    return out


def _loss_and_grads(g, tgt, backend):
    gp = to_torch(g)
    cam = gt.Camera.create(**CAM, device="cpu")
    img, aux = gt.render(gp, cam, gt.RenderConfig(backend=backend, chunk=32, **KW),
                         return_aux=True)
    loss = torch.mean((img - torch.from_numpy(tgt)) ** 2)
    loss.backward()
    return loss.item(), {f: getattr(gp, f).grad.numpy() for f in _FIELDS}, aux


@pytest.mark.parametrize("backend", ["stream", "pallas"])
@pytest.mark.parametrize("name", ["thin", "fat"])
def test_render_grads_match_gsjax_xla(ref, name, backend):
    """Both blend backends: kernel D's plain version, or kernel F's and
    the slot gather's scatter-set VJP."""
    r = ref[name]
    assert all(v == 0 for v in r["ovf"].values()), r["ovf"]
    loss, grads, aux = _loss_and_grads(r["g"], r["tgt"], backend)
    assert int(aux["n_fat_overflow"]) == 0
    assert abs(loss - r["loss"]) <= 1e-5 * r["loss"]
    for f in _FIELDS:
        a, b = np.asarray(getattr(r["grads"], f)), grads[f]
        assert np.isfinite(b).all(), f
        peak = np.abs(a).max() + 1e-12
        rel = np.abs(a - b) / peak
        # tests/test_stream.py:149-154: the bulk agrees tightly; a few
        # inclusion-threshold flips change some splats' gradients
        assert np.percentile(rel, 99) < 5e-3, (f, np.percentile(rel, 99))
        assert rel.max() < 1e-1, (f, rel.max())
    if name == "fat":
        # the splats split into copy rows: without the copy-row segment sum
        # their parents would keep only their primary block's gradient
        gp = to_torch(r["g"])
        cfg = gt.RenderConfig(chunk=32, **KW)
        p = project(gp, gt.Camera.create(**CAM, device="cpu"), cfg)
        n_ex = ths._footprint_blocks(p, cfg.tiles_x(W), cfg.tiles_y(H), cfg)[-1]
        fat = (n_ex > 0).numpy()
        assert fat.sum() > 10
        a = np.asarray(r["grads"].sh)[fat]
        assert np.abs(grads["sh"][fat]).max() > 0
        assert np.abs(grads["sh"][fat] - a).max() <= 5e-3 * np.abs(a).max()


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


def _segments(case):
    """tests/test_homegather_precision.py's inputs: (n, seg_base, d_tail)."""
    if case == "exact_small":
        rng = np.random.default_rng(1)
        n, c = 500, 2
        lens = rng.integers(0, 7, n)
        d_tail = rng.normal(size=(int(lens.sum()), c)).astype(np.float32)
    else:  # adversarial lognormal magnitudes, ~200k copy rows
        rng = np.random.default_rng(0)
        n = 60_000
        lens = np.minimum(rng.poisson(200_000 / n, n), 255)
        f = int(lens.sum())
        d_tail = rng.normal(size=(f, 3)).astype(np.float32) * rng.lognormal(
            0, 2, size=(f, 1)).astype(np.float32)
    return n, np.concatenate([[0], np.cumsum(lens)]), d_tail


@pytest.mark.parametrize("case", ["exact_small", "lognormal_200k"])
def test_home_gather_vjp_matches_gsjax(case):
    n, base, d_tail = _segments(case)
    f, c = d_tail.shape
    rng = np.random.default_rng(2)
    # a random sort permutation, truncated to NH rows: truncated entries
    # must get zero gradient
    perm_full = rng.permutation(n + f)
    nh = n + (f * 3) // 4
    inv = np.empty(n + f, np.int64)
    inv[perm_full] = np.arange(n + f)
    d_full = np.concatenate([rng.normal(size=(n, c)).astype(np.float32), d_tail])
    d = d_full[perm_full[:nh]]  # home-row cotangents

    x = torch.zeros((n, c), requires_grad=True)
    out = ths.home_gather(x, torch.zeros((f, c)), torch.from_numpy(perm_full[:nh]),
                          torch.from_numpy(inv[:n]), torch.from_numpy(inv[n:]),
                          torch.from_numpy(base))
    out.backward(torch.from_numpy(d))
    dx = x.grad.numpy()
    bwd = jax.jit(lambda inv, inv_tail, seg_base, d: _home_gather_bwd(
        (n, f, inv, inv_tail, seg_base), d)[0])  # one compile, not one per op
    dx_j = np.asarray(bwd(jnp.asarray(inv[:n], jnp.int32), jnp.asarray(inv[n:], jnp.int32),
                          jnp.asarray(base, jnp.int32), jnp.asarray(d)))

    kept = inv < nh
    dk = np.where(kept[:, None], d_full, 0.0).astype(np.float64)
    ref = np.where(kept[:n, None], dk[:n], 0.0)
    lens = np.diff(base)
    ref += np.where((lens > 0)[:, None],
                    np.add.reduceat(np.concatenate([dk[n:], np.zeros((1, c))]),
                                    np.minimum(base[:-1], f), axis=0), 0.0)
    if case == "exact_small":
        np.testing.assert_allclose(dx, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dx, dx_j, rtol=1e-5, atol=1e-5)
    else:  # tests/test_homegather_precision.py:40-43
        err = np.abs(dx - ref)
        assert err.max() < 0.02, err.max()
        assert (err / np.maximum(np.abs(ref), 1e-6)).max() < 20.0
        assert np.abs(dx - dx_j).max() < 0.02


def test_fexp_grad_matches_gsjax():
    x = np.concatenate([np.linspace(-90.0, 0.0, 20_001, dtype=np.float32),
                        np.float32([-1e-30, -0.0])])
    xt = torch.from_numpy(x).requires_grad_()
    t_fexp(xt).backward(torch.ones_like(xt))
    gj = np.asarray(jax.vmap(jax.grad(j_fexp))(jnp.asarray(x)))
    np.testing.assert_array_max_ulp(xt.grad.numpy(), gj, 1)


def test_adam_steps_match_gsjax(ref):
    """Three make_step_fn steps with default_optimizer against gsjax's
    gradient + default_optimizer().update on the thin scene."""
    r = ref["thin"]
    gp = to_torch(r["g"])
    opt = tt.default_optimizer(gp)
    step = tt.make_step_fn(gt.Camera.create(**CAM, device="cpu"),
                           gt.RenderConfig(backend="stream", chunk=32, **KW), opt)
    tgt = torch.from_numpy(r["tgt"])
    losses_t = [float(step(gp, tgt)) for _ in range(3)]

    gj, tgt_j = r["g"], jnp.asarray(r["tgt"])
    optj = j_default_optimizer()
    state = optj.init(gj)
    losses_j = []
    for _ in range(3):
        (val, _), grads = ref["vg"](gj, tgt_j)
        updates, state = optj.update(grads, state, gj)
        gj = optax.apply_updates(gj, updates)
        losses_j.append(float(val))
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    g0 = r["g"]
    lrs = dict(means=1.6e-4, log_scales=5e-3, quats=1e-3, sh=2.5e-3,
               opacity_logits=5e-2)
    for f in _FIELDS:
        # the updates, in units of 3 steps at the field's learning rate:
        # Adam normalises each entry, so a gradient that differs by a
        # rounding in sign or size near zero moves its entry by up to a
        # step either way; the bulk must agree to 1%
        u_t = getattr(gp, f).detach().numpy() - np.asarray(getattr(g0, f))
        u_j = np.asarray(getattr(gj, f)) - np.asarray(getattr(g0, f))
        d = np.abs(u_t - u_j) / (3 * lrs[f])
        assert np.abs(u_j).max() > 0, f
        assert np.percentile(d, 99) < 1e-2, (f, np.percentile(d, 99))
        assert d.max() < 2.0, (f, d.max())


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
    with pytest.raises(NotImplementedError, match="multi-device"):
        tt.fit(g, cams, targets, cfg, steps=1, mesh=object())


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
    for mode in ("orbit", "fixed-lazy"):
        with pytest.raises(NotImplementedError, match="lazy frame plans"):
            trun.main(["--mode", mode, "--device", "cpu"])
