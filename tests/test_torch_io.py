"""gsjax_torch parity: the .splat loader and writer, their streamed forms,
and Gaussians' scene-store utilities against gsjax's on the same bytes."""

import io

import numpy as np
import pytest
import torch

import gsjax
import gsjax_torch as gt
from gsjax.io import stream as jstream
from test_io import _random_gaussians
from test_stream_io import _NoSeek
from test_stream_io import _scene as _stream_scene

from test_torch_io_common import _np, assert_activated, assert_bits, to_torch


def test_splat_save_and_load_match(tmp_path):
    rng = np.random.default_rng(0)
    gj = _random_gaussians(rng)
    gp = to_torch(gj)
    bj, bp = gsjax.save_splat(gj), gt.save_splat(gp, tmp_path / "s.splat")
    assert (tmp_path / "s.splat").read_bytes() == bp and len(bp) == len(bj)
    rj = np.frombuffer(bj, np.uint8).reshape(-1, 32)
    rp = np.frombuffer(bp, np.uint8).reshape(-1, 32)
    np.testing.assert_array_equal(rp[:, :12], rj[:, :12])  # positions, as stored
    # scales = exp(log_scales), torch's exp against jnp's: 1 ulp
    np.testing.assert_array_max_ulp(rp[:, 12:24].copy().view(np.float32),
                                    rj[:, 12:24].copy().view(np.float32), 1)
    # the u8 columns round activated values: a 1-ulp input may cross a .5
    assert np.abs(rp[:, 24:].astype(int) - rj[:, 24:].astype(int)).max() <= 1
    assert (rp[:, 24:] != rj[:, 24:]).mean() < 0.01
    # the same bytes load to the same scene
    assert_activated(gt.load_splat(bj, device="cpu"), gsjax.load_splat(bj))
    assert_activated(gt.load_splat(tmp_path / "s.splat", device="cpu"),
                     gsjax.load_splat(bp))


def test_in_repo_splat_scene_matches():
    gj = gsjax.load_splat("scene.splat")
    gp = gt.load_splat("scene.splat", device="cpu")
    assert gp.n == 400
    assert_activated(gp, gj)


def test_splat_rejects_bad_length():
    with pytest.raises(ValueError, match="multiple of 32"):
        gt.load_splat(b"\x00" * 33, device="cpu")


def test_splat_streamed_matches_and_progress(tmp_path):
    gj = _stream_scene(np.random.default_rng(5), k=1)
    path = tmp_path / "s.splat"
    gsjax.save_splat(gj, path)
    ticks = []
    gp = gt.load_splat_streamed(path, on_progress=lambda d, t: ticks.append((d, t)),
                                chunk_bytes=1000, device="cpu")  # not a row multiple
    assert_bits(gp, gt.load_splat(path, device="cpu"))
    assert_activated(gp, jstream.load_splat_streamed(path, chunk_bytes=1000))
    done = [d for d, _t in ticks]
    assert done == sorted(done) and len(ticks) > 3
    assert done[-1] == ticks[0][1] == path.stat().st_size


def test_splat_streamed_unseekable():
    buf = gsjax.save_splat(_stream_scene(np.random.default_rng(6), n=64, k=1))
    ticks = []
    gp = gt.load_splat_streamed(_NoSeek(buf), on_progress=lambda d, t: ticks.append((d, t)),
                                chunk_bytes=640, device="cpu")
    assert_bits(gp, gt.load_splat(buf, device="cpu"))
    assert ticks and all(t == -1 for _d, t in ticks)  # unsized stream


def test_splat_streamed_rejects_partial_row():
    buf = gsjax.save_splat(_stream_scene(np.random.default_rng(7), n=8, k=1))[:-7]
    with pytest.raises(ValueError, match="mid-row"):
        gt.load_splat_streamed(io.BytesIO(buf), device="cpu")


def test_gaussians_shape_utilities_match():
    gj = _stream_scene(np.random.default_rng(10), n=20, k=4)
    other = _stream_scene(np.random.default_rng(11), n=7, k=16)
    gp, op = to_torch(gj), to_torch(other)
    assert (gp.n, gp.sh_degree, op.sh_degree) == (20, 1, 3)
    with torch.no_grad():
        for d in (0, 1, 2, 3):
            assert_bits(gp.with_sh_degree(d), gj.with_sh_degree(d))
        assert_bits(gp.pad_to(32), gj.pad_to(32))
        assert_bits(gp.slice(3, 11), gj.slice(3, 11))
        assert_bits(gp.concat(op), gj.concat(other))
        assert gp.with_sh_degree(1) is gp and gp.pad_to(20) is gp
    np.testing.assert_allclose(_np(gp.covariances()), np.asarray(gj.covariances()),
                               rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError):
        gp.pad_to(3)
    # made under torch.no_grad(), a derived scene holds parameters of its own
    with torch.no_grad():
        for d in (gp.slice(0, 20), gp.with_sh_degree(0), gt.transforms.translate(gp, (1, 0, 0))):
            own = list(d.parameters())
            assert len(own) == 5
            assert not {p.data_ptr() for p in own} & {p.data_ptr() for p in gp.parameters()}
    # made under autograd, a derived scene stays a function of its source
    cat = gp.concat(op)
    assert not list(cat.parameters())
    cat.sh.sum().backward()
    assert torch.equal(gp.sh.grad, torch.ones_like(gp.sh))
    assert torch.equal(op.sh.grad, torch.ones_like(op.sh))
