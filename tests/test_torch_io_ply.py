"""gsjax_torch parity: the .ply parsers (numpy and the native parser)
against gsjax's on the same bytes."""

import numpy as np
import pytest

import gsjax
import gsjax_torch as gt
from gsjax_torch.io import native as tnative
from gsjax_torch.io import ply as tply
from test_io import _write_ply

from test_torch_io_common import _np, assert_bits


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
