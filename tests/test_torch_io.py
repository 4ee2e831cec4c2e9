"""gsjax_torch parity: scene IO and edits against gsjax on the same bytes
— .splat, plain .ply (numpy and native parsers), quantized .ply (padded
and banded), the streamed loaders, the scene store's shape utilities and
the five transforms.

Stored floats (raw .ply fields, quantized codebook values, raw-parameter
bytes) must be bit-equal; fields that go through from_activated (.splat)
are held to tests/test_torch_core.py::test_synth_scenes_match's bounds
(torch's log / log1p against jnp's); renders to 2e-5 of gsjax's `xla`
backend (tests/test_torch_stream.py's bound); the banded gradient to
jax.grad through gsjax's `xla` backend at tests/test_torch_train.py's
bounds. gsjax's `xla` render and its gradient compile once per module."""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gsjax
import gsjax_torch as gt
from gsjax.io import ply as jply
from gsjax.io import qply as jqply
from gsjax.io import stream as jstream
from gsjax_torch.io import native as tnative
from gsjax_torch.io import ply as tply
from gsjax_torch.io import qply as tqply
from gsjax_torch.io import stream as tstream
from test_io import _random_gaussians, _write_ply
from test_qply import _build_qply
from test_stream_io import _NoSeek
from test_stream_io import _scene as _stream_scene

torch.set_num_threads(2)

_FIELDS = ("means", "log_scales", "quats", "sh", "opacity_logits")
CAM = dict(fx=100.0, fy=100.0, width=64, height=48)  # conftest's default_camera
SHIFT = np.array([0, 0, 5.0], np.float32)  # test_qply: the codebook scene, in view


def to_torch(g):
    return gt.Gaussians.from_numpy(*(np.asarray(getattr(g, f)) for f in _FIELDS),
                                   device="cpu")


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_bits(gp, gj):
    """Every raw field bit-equal (shapes too)."""
    assert gp.n == gj.n
    for f in _FIELDS:
        np.testing.assert_array_equal(_np(getattr(gp, f)), _np(getattr(gj, f)), f)


def assert_activated(gp, gj):
    """from_activated's fields: means, quats and sh as stored (bit-equal),
    log_scales within 1 ulp, the opacity logit within one ulp of each of
    its terms plus one of their difference (test_synth_scenes_match)."""
    for f in ("means", "quats", "sh"):
        np.testing.assert_array_equal(_np(getattr(gp, f)), _np(getattr(gj, f)), f)
    np.testing.assert_array_max_ulp(_np(gp.log_scales), _np(gj.log_scales), 1)
    a, b = _np(gp.opacity_logits), _np(gj.opacity_logits)
    op = 1.0 / (1.0 + np.exp(-b.astype(np.float64)))
    ulp = lambda v: np.spacing(np.abs(v).astype(np.float32))
    assert np.all(np.abs(a - b) <= ulp(np.log(op)) + ulp(np.log1p(-op)) + ulp(b))


def shifted(g):
    return dataclasses.replace(g, means=np.asarray(g.means) * 0.2 + SHIFT)


def _cam():
    return gt.Camera.create(**CAM, device="cpu")


# --------------------------------------------------------------------------
# .splat (tests/test_io.py)
# --------------------------------------------------------------------------


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


# --------------------------------------------------------------------------
# plain .ply (tests/test_io.py)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_rest,use_shs,fmt", [
    (45, True, ""), (9, True, ""), (45, False, ""), (45, True, "polycam"),
    (24, True, ""),  # 9 coefficients a channel: down to degree 2
])
def test_ply_numpy_parse_matches(n_rest, use_shs, fmt):
    buf, props, data = _write_ply(np.random.default_rng(1), n_rest=n_rest)
    gp = gt.load_ply(buf, use_shs=use_shs, format=fmt, use_native=False, device="cpu")
    assert_bits(gp, gsjax.load_ply(buf, use_shs=use_shs, format=fmt, use_native=False))
    if n_rest == 45 and use_shs and not fmt:
        ix = {p: i for i, p in enumerate(props)}
        # f_rest_39 (channel B, coefficient 10) is read
        np.testing.assert_array_equal(_np(gp.sh[:, 10, 2]), data[:, ix["f_rest_39"]])


def test_ply_rejects_garbage():
    with pytest.raises(ValueError, match="Invalid PLY"):
        gt.load_ply(b"not a ply file at all", use_native=False, device="cpu")


@pytest.mark.parametrize("n_rest", [45, 9, 0])
def test_ply_native_matches_numpy(n_rest):
    """The native parser (native/loader.cpp, built into gsjax_torch/_build)
    bit-equal to the numpy parser and to gsjax's."""
    buf, _, _ = _write_ply(np.random.default_rng(2), n=64, n_rest=n_rest)
    out = tnative.parse_ply_native(buf)
    assert out is not None
    assert tnative.library_path().startswith(tnative.BUILD_DIR)
    g_native = tply._assemble(out, "", "cpu")
    g_numpy = gt.load_ply(buf, use_native=False, device="cpu")
    assert_bits(g_native, g_numpy)
    assert_bits(gt.load_ply(buf, device="cpu"), gsjax.load_ply(buf, use_native=False))


def test_ply_native_declines_other_layouts():
    """A field the native parser needs is missing (opacity: the numpy
    parser's default logit 30): None, and load_ply takes the numpy
    parser."""
    buf, _, _ = _write_ply(np.random.default_rng(3), n=8)
    b2 = buf.replace(b"property float opacity\n", b"property float other\n")
    assert tnative.parse_ply_native(b2) is None
    assert_bits(gt.load_ply(b2, device="cpu"), gsjax.load_ply(b2, use_native=False))


@pytest.mark.parametrize("k", [1, 4, 16])
def test_save_ply_bytes_match(k, tmp_path):
    gj = _stream_scene(np.random.default_rng(4), n=33, k=k)
    bp = tply.save_ply(to_torch(gj), tmp_path / "s.ply")
    assert bp == jply.save_ply(gj) == (tmp_path / "s.ply").read_bytes()
    assert_bits(gt.load_ply(bp, device="cpu"), gj)


# --------------------------------------------------------------------------
# quantized .ply (tests/test_qply.py)
# --------------------------------------------------------------------------


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


@pytest.fixture(scope="module")
def banded():
    """test_banded_render_matches_padded's scene: the port's BandedGaussians
    and gsjax's, the means shifted into view; gsjax's xla render and its
    jax.grad of sum(img²) through the banded scene."""
    buf, _ = _build_qply(np.random.default_rng(0), counts=(8, 8, 8, 8))
    bj = gsjax.load_ply(buf, quantized=True, banded=True)
    bj = dataclasses.replace(bj, groups=tuple(shifted(g) for g in bj.groups))
    bp = gt.BandedGaussians.from_groups([to_torch(g) for g in bj.groups])
    cam = gsjax.Camera.create(**CAM)
    cfg = gsjax.RenderConfig(backend="xla", tile_list_cap=256, chunk=32)

    def loss(b):
        img = gsjax.render(b, cam, cfg)
        return jnp.sum(img ** 2), img

    (_, img), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(bj)
    return bj, bp, np.asarray(img), grads


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


# --------------------------------------------------------------------------
# streamed ingest (tests/test_stream_io.py)
# --------------------------------------------------------------------------


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


@pytest.mark.parametrize("k", [1, 16])
def test_ply_streamed_matches(k, tmp_path):
    gj = _stream_scene(np.random.default_rng(8), k=k)
    path = tmp_path / "s.ply"
    jply.save_ply(gj, path)
    ticks = []
    gp = gt.load_ply_streamed(path, on_progress=lambda d, t: ticks.append((d, t)),
                              chunk_bytes=4096 + 13, device="cpu")  # never row-aligned
    assert_bits(gp, gsjax.load_ply(path))
    assert_bits(gp, jstream.load_ply_streamed(path, chunk_bytes=4096 + 13))
    done = [d for d, _t in ticks]
    assert done == sorted(done) and done[-1] == path.stat().st_size and len(ticks) > 2


def test_ply_streamed_truncated_and_header_only_raise():
    buf = jply.save_ply(_stream_scene(np.random.default_rng(9), n=32, k=1))
    with pytest.raises(ValueError, match="stream ended"):
        gt.load_ply_streamed(io.BytesIO(buf[: len(buf) - 40]), chunk_bytes=512,
                             device="cpu")
    with pytest.raises(ValueError, match="header_end_not_found"):
        gt.load_ply_streamed(io.BytesIO(b"ply\nformat binary_little_endian 1.0\n"),
                             device="cpu")


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


# --------------------------------------------------------------------------
# the scene store and the transforms (tests/test_transforms.py)
# --------------------------------------------------------------------------


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


_EDITS = {
    "translate": lambda t, g: t.translate(g, (0.5, -0.2, 0.1)),
    "rotate": lambda t, g: t.rotate(g, np.array([0.9, 0.1, -0.2, 0.15])),
    "scale": lambda t, g: t.scale(g, 1.7),
    "scale_axes": lambda t, g: t.scale(g, (1.5, 0.5, 2.0)),
    "limit_box": lambda t, g: t.limit_box(g, -0.2, 0.2, -0.2, 0.2, 0.0, 100.0),
    "crop_box": lambda t, g: t.crop_box(g, -0.5, 0.5, -0.5, 0.5, 0.0, 100.0),
}


@pytest.mark.parametrize("edit", list(_EDITS))
def test_transforms_match_gsjax(edit):
    from conftest import make_random_scene

    gj = make_random_scene(np.random.default_rng(12), n=40)
    gp = to_torch(gj)
    ej, ep = _EDITS[edit](gsjax.transforms, gj), _EDITS[edit](gt.transforms, gp)
    assert ep.n == ej.n and ep.device == gp.device
    if edit == "crop_box":
        assert ep.n < 40
    for f in _FIELDS:
        # elementwise edits bit-equal; rotate's matmul and norm to rounding
        np.testing.assert_allclose(_np(getattr(ep, f)), np.asarray(getattr(ej, f)),
                                   rtol=0, atol=2e-6 if edit == "rotate" else 0, err_msg=f)
    if edit != "crop_box":  # the edit is differentiable back to g
        ep.means.sum().backward()
        assert gp.means.grad is not None and bool(gp.means.grad.abs().max() > 0)
    if edit == "limit_box":
        with pytest.raises(ValueError):
            gt.transforms.limit_box(gp, 1, -1, 0, 1, 0, 1)
