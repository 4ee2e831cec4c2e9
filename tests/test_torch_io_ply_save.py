"""gsjax_torch parity: save_ply's bytes, the streamed .ply loader and
the native parser's refusals against gsjax's."""

import io

import numpy as np
import pytest

import gsjax
import gsjax_torch as gt
from gsjax.io import ply as jply
from gsjax.io import stream as jstream
from gsjax_torch.io import native as tnative
from gsjax_torch.io import ply as tply
from test_io import _write_ply
from test_stream_io import _scene as _stream_scene

from test_torch_io_common import assert_bits, to_torch


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
