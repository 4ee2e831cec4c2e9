"""gsjax_torch parity: the flat slot-stream backend (render/flat.py)
against gsjax/render/pallas_flat.py's non-Pallas functions on the CPU —
the slot tables, the chunk-aligned gather and its scatter-set VJP — and
its plain blends (kernels E's and F's plain versions) against autograd
and against the stream backend's. gsjax's Pallas kernels (_fwd_call,
_bwd_call, blend_slots) are not called: their CPU interpret mode costs
tens of seconds; the whole flat render is held to gsjax's xla backend in
test_torch_stream.py and test_torch_train.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_random_scene

import gsjax
import gsjax_torch as gt
from gsjax.render import pallas_flat as jflat
from gsjax_torch.render import flat
from gsjax_torch.render.binning import build_tile_bins
from gsjax_torch.render.composite import att_table, clipped_pair_stream
from gsjax_torch.render.homesort import build_home_layout
from gsjax_torch.render.project import project
from gsjax_torch.render.stream import blend_stream

torch.set_num_threads(2)

_FIELDS = ("means", "log_scales", "quats", "sh", "opacity_logits")
W, H = 96, 64
CHUNK, K = 32, 9


def _starts(case):
    """Tile segment offsets [T+1] for 40 tiles: random counts with empty
    tiles; every count a multiple of the chunk; or clipped by a pair cap
    (as clipped_pair_stream clips them)."""
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 3 * CHUNK, 40) * (rng.uniform(size=40) < 0.7)
    if case == "multiples":
        counts = rng.integers(0, 4, 40) * CHUNK
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    if case == "pair_cap":
        starts = np.minimum(starts, starts[-1] // 2)
    assert (np.diff(starts) == 0).any()
    return starts


@pytest.mark.parametrize("case", ["empty_tiles", "multiples", "pair_cap"])
def test_slot_tables_match_gsjax(case):
    starts = _starts(case)
    ncb = int(starts[-1]) // CHUNK + starts.shape[0]  # S // chunk + T + 1
    # jitted: one compile instead of one per eager op
    want = jax.jit(jflat._slot_tables, static_argnums=(1, 2))(jnp.asarray(starts), CHUNK, ncb)
    got = flat.slot_tables(torch.from_numpy(starts), CHUNK, ncb)
    for name, a, b in zip(("tile_of", "win", "cbase", "valid_count"), want, got):
        assert b.dtype == torch.int32, name
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


def _pairs(rng, n=200):
    """att_rows [n, 9], pid_sorted [S] (unique pair ids < n·K) and starts."""
    starts = _starts("empty_tiles")
    s = int(starts[-1])
    pid = rng.choice(n * K, size=s, replace=False).astype(np.int32)
    att = rng.normal(size=(n, 9)).astype(np.float32)
    return att, pid, starts


def test_chunked_pair_attrs_match_gsjax():
    att, pid, starts = _pairs(np.random.default_rng(0))
    want = jax.jit(lambda a, p, s: jflat.chunked_pair_attrs(
        a, p, s, gsjax.RenderConfig(chunk=CHUNK), K))(jnp.asarray(att), jnp.asarray(pid),
                                                       jnp.asarray(starts))
    got = flat.chunked_pair_attrs(torch.from_numpy(att), torch.from_numpy(pid),
                                  torch.from_numpy(starts), gt.RenderConfig(chunk=CHUNK), K)
    for name, a, b in zip(("att_al", "tile_of", "cbase"), want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


def test_gather_pair_attrs_vjp_matches_gsjax():
    rng = np.random.default_rng(1)
    att, pid, starts = _pairs(rng)
    n = att.shape[0]
    # pid_al as chunked_pair_attrs builds it (the slot tables are tested above)
    ncb = pid.shape[0] // CHUNK + starts.shape[0]
    _, win, _, valid = flat.slot_tables(torch.from_numpy(starts), CHUNK, ncb)
    lane = np.arange(CHUNK)
    pid_pad = np.concatenate([pid, np.zeros(CHUNK, np.int32)])
    pid_al = np.where(lane < valid.numpy()[:, None], pid_pad[win.numpy()[:, None] + lane],
                      n * K).astype(np.int32)
    att_pad = np.concatenate([att, np.zeros((1, 9), np.float32)])
    ct = rng.normal(size=(ncb, CHUNK, 9)).astype(np.float32)

    @jax.jit
    def gather_and_vjp(a, p, c):
        out, vjp = jax.vjp(lambda x: jflat.gather_pair_attrs(x, p, K), a)
        return out, vjp(c)[0]

    out_j, d_j = gather_and_vjp(jnp.asarray(att_pad), jnp.asarray(pid_al), jnp.asarray(ct))
    a_t = torch.from_numpy(att_pad).requires_grad_()
    out_t = flat.gather_pair_attrs(a_t, torch.from_numpy(pid_al), K)
    out_t.backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    d_j = np.asarray(d_j)
    assert np.abs(d_j[:-1]).max() > 0 and not d_j[-1].any()
    np.testing.assert_allclose(a_t.grad.numpy(), d_j, rtol=1e-6, atol=1e-6 * np.abs(d_j).max())


def _scene_inputs(name):
    """A scene's home rows and pair stream at 96×64, chunk 32:
    test_torch_train.py's thin scene, or its fat-splat scene."""
    rng = np.random.default_rng(0)
    if name == "thin":
        g = make_random_scene(rng, n=300, sh_degree=1, spread=1.2, z_range=(3.0, 8.0))
    else:
        g = make_random_scene(rng, n=300, sh_degree=1, spread=1.0, z_range=(2.0, 6.0))
        g = dataclasses.replace(g, log_scales=g.log_scales + 2.0)
    gp = gt.Gaussians.from_numpy(*(np.asarray(getattr(g, f)) for f in _FIELDS), device="cpu")
    cam = gt.Camera.create(fx=80.0, fy=80.0, width=W, height=H, device="cpu")
    cfg = gt.RenderConfig(backend="pallas", chunk=CHUNK, fat_max_blocks=64, fat_cap=2048)
    with torch.no_grad():
        ph, layout = build_home_layout(project(gp, cam, cfg), cam, cfg)
        bins = build_tile_bins(ph, cam, cfg, anchor="home", layout=layout)
    assert int(layout.n_fat_overflow) == 0
    pid, starts, _ = clipped_pair_stream(bins, cfg)
    return att_table(ph), pid, starts, bins, cfg


def _cotangents(n_tiles, seed=4):
    rng = np.random.default_rng(seed)
    ct_img = torch.from_numpy(rng.normal(size=(n_tiles, 256, 3)).astype(np.float32))
    ct_T = torch.from_numpy(rng.normal(size=(n_tiles, 256)).astype(np.float32))
    return ct_img, ct_T


@pytest.mark.parametrize("name", ["thin", "fat"])
def test_slots_backward_matches_autograd_of_forward(name):
    """Kernel F's plain version (the hand-derived VJP, replayed from E's
    exit state) against autograd through kernel E's plain version, with
    random cotangents on both outputs (ct_T reaches the ct_T·T_act term);
    test_torch_train.py's bounds for the stream backward."""
    att, pid, starts, bins, cfg = _scene_inputs(name)
    att_al, tile_of, cbase = flat.chunked_pair_attrs(att, pid, starts, cfg, K)
    att_al = att_al.detach().requires_grad_()
    args = (starts, cbase, tile_of, 0)
    out = flat.slots_forward_plain(att_al, *args, bins.tiles_x, bins.band_rows, cfg)
    ct_img, ct_T = _cotangents(out.shape[0])
    (d_auto,) = torch.autograd.grad(
        (out[:, 0:3].transpose(1, 2) * ct_img).sum() + (out[:, 3] * ct_T).sum(), att_al)
    d = flat.slots_backward(att_al.detach(), *args, out.detach(), ct_img, ct_T,
                            bins.tiles_x, bins.band_rows, cfg)
    assert d.shape == att_al.shape
    d, d_auto = d.view(-1, 9), d_auto.view(-1, 9)
    peak = d_auto.abs().amax(dim=0) + 1e-12
    rel = ((d - d_auto).abs() / peak).numpy()
    assert (d_auto.abs().amax(dim=0) > 0).all()
    assert np.percentile(rel, 99.9) < 1e-4, np.percentile(rel, 99.9, axis=0)
    assert rel.max() < 1e-2, rel.max(axis=0)


def test_flat_matches_stream_plain_paths():
    """One scene through both backends' plain paths: the same blend over
    the same pairs, so the image and the home-row gradients (after the
    slot gather's VJP) agree."""
    att, pid, starts, bins, cfg = _scene_inputs("thin")
    ct_img, ct_T = _cotangents(bins.tiles_x * bins.band_rows, seed=5)
    res = []
    for backend in ("stream", "pallas"):
        a = att.detach().requires_grad_()
        if backend == "stream":
            img, T = blend_stream(a, pid, starts, 0, bins.tiles_x, cfg)
        else:
            att_al, tile_of, cbase = flat.chunked_pair_attrs(a, pid, starts, cfg, K)
            img, T = flat.blend_slots(att_al, starts, cbase, tile_of, 0, bins.tiles_x,
                                      bins.band_rows, cfg)
        ((img * ct_img).sum() + (T * ct_T).sum()).backward()
        res.append((img.detach(), T.detach(), a.grad))
    (img_s, T_s, d_s), (img_f, T_f, d_f) = res
    assert float((img_f - img_s).abs().max()) <= 1e-6
    assert float((T_f - T_s).abs().max()) <= 1e-6
    peak = d_s.abs().amax(dim=0)
    assert (peak > 0).all()
    assert float(((d_f - d_s).abs() / peak).max()) <= 1e-6
