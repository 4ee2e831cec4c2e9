"""gsjax_torch parity: the quantized .ply codebook format, its streamed
form and BandedGaussians against gsjax's."""

import io

import numpy as np
import pytest
import torch

import gsjax
import gsjax_torch as gt
from gsjax.io import qply as jqply
from gsjax_torch.io import qply as tqply
from gsjax_torch.io import stream as tstream
from test_qply import _build_qply

from test_torch_io_common import _FIELDS, _cam, assert_bits, banded, shifted, to_torch


def test_qply_roundtrip():
    buf, _ = _build_qply(np.random.default_rng(0))
    gp = gt.load_ply(buf, quantized=True, device="cpu")
    assert gp.n == 18 and gp.sh_degree == 3
    assert_bits(gp, gsjax.load_ply(buf, quantized=True))
    assert not any(p.grad_fn for p in gp.parameters())  # fresh leaves
    assert [n for n, _ in gp.named_parameters()] == list(_FIELDS)


def test_qply_rejects_bad_header():
    with pytest.raises(ValueError, match="4 quantized vertex groups"):
        gt.load_ply(b"ply\nformat binary_little_endian 1.0\nelement vertex 3\n"
                    b"end_header\n" + b"\0" * 64, quantized=True, device="cpu")
    with pytest.raises(ValueError, match="banded=True requires quantized"):
        gt.load_ply(b"ply\n", banded=True, device="cpu")


def test_qply_banded_storage():
    buf, expected = _build_qply(np.random.default_rng(0), counts=(40, 4, 3, 6))
    bg = gt.load_ply(buf, quantized=True, banded=True, device="cpu")
    bj = gsjax.load_ply(buf, quantized=True, banded=True)
    assert isinstance(bg, gt.BandedGaussians) and isinstance(bg, torch.nn.Module)
    assert bg.band_counts == bj.band_counts == tuple(e["means"].shape[0] for e in expected)
    assert tuple(g.sh.shape[1] for g in bg.groups) == (1, 4, 9, 16)
    assert bg.n == bj.n and bg.sh_degree == 3 and bg.sh_bytes() == bj.sh_bytes()
    for gp, gj in zip(bg.groups, bj.groups):
        assert_bits(gp, gj)
    # an optimizer reaches every group's parameters
    assert len(list(bg.parameters())) == 5 * 4
    with torch.no_grad():
        assert_bits(bg.to_gaussians(), gt.load_ply(buf, quantized=True, device="cpu"))


def test_qply_streamed_matches_whole_buffer():
    buf, _ = _build_qply(np.random.default_rng(0), counts=(50, 40, 30, 60))
    seen = []
    gp = tstream.load_qply_streamed(io.BytesIO(buf), on_progress=lambda d, t: seen.append((d, t)),
                                    chunk_bytes=97, device="cpu")  # tiny, misaligned
    assert_bits(gp, tqply.parse_qply(buf, device="cpu"))
    assert_bits(gp, jqply.parse_qply(buf))
    dones = [d for d, _t in seen]
    assert dones == sorted(dones) and seen[-1][0] >= len(buf) - 8192
    assert all(t == len(buf) for _d, t in seen)
    bg = tstream.load_qply_streamed(io.BytesIO(buf), banded=True, chunk_bytes=1013,
                                    device="cpu")
    for gp_, gj_ in zip(bg.groups, jqply.parse_qply(buf, banded=True).groups):
        assert_bits(gp_, gj_)


@pytest.mark.parametrize("backend", ["stream", "pallas"])
def test_banded_render_matches_padded(banded, backend):
    """A banded scene renders as its zero-padded equivalent (the per-degree
    SH evaluation is exact), and as gsjax's xla render of it."""
    _, bp, img_j, _ = banded
    cfg = gt.RenderConfig(backend=backend, chunk=32)
    with torch.no_grad():
        img_b = gt.render(bp, _cam(), cfg).numpy()
        img_p = gt.render(bp.to_gaussians(), _cam(), cfg).numpy()
    np.testing.assert_allclose(img_b, img_p, atol=1e-6)
    assert np.abs(img_b - img_j).max() < 2e-5 and img_b.max() > 0


def test_banded_gradient_matches_gsjax(banded):
    """Gradients of sum(img²) reach every group's parameters, within
    test_torch_train's bounds of jax.grad through gsjax's xla backend."""
    _, bp, _, grads_j = banded
    bp.zero_grad(set_to_none=True)
    (gt.render(bp, _cam(), gt.RenderConfig(chunk=32)) ** 2).sum().backward()
    for gp, gj in zip(bp.groups, grads_j.groups):
        for f in _FIELDS:
            a, b = np.asarray(getattr(gj, f)), getattr(gp, f).grad.numpy()
            assert np.isfinite(b).all(), f
            rel = np.abs(a - b) / (np.abs(a).max() + 1e-12)
            assert np.percentile(rel, 99) < 5e-3 and rel.max() < 1e-1, (f, rel.max())
        assert np.abs(gp.means.grad.numpy()).sum() > 0


def test_qply_mixed_degrees_render(banded):
    """The padded load of the mixed-degree file renders as gsjax's xla
    render of the same scene (banded: the padding is inert)."""
    buf, _ = _build_qply(np.random.default_rng(0), counts=(8, 8, 8, 8))
    gj = shifted(gsjax.load_ply(buf, quantized=True))
    with torch.no_grad():
        img = gt.render(to_torch(gj), _cam(), gt.RenderConfig(chunk=32)).numpy()
    assert np.isfinite(img).all() and img.max() > 0
    assert np.abs(img - banded[2]).max() < 2e-5
