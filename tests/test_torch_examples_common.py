"""Helpers of the example apps' parity tests (test_torch_examples_*.py):
the reference examples' demo scene, the sizes the tests run the apps at,
gsjax's render, and the .splat comparison.

The apps run at the test budget (n ≤ 400, 96×64; the band mesh 128 rows
over 8 bands) with their cameras' fields of view kept (fx scaled with
the width). The gsjax side renders with its `xla` backend under
footprint_clamp=True: no interpret-mode layout kernel runs, and where it
clamps no splat (n_clamped 0, each render asserts it) its span-budget
bins hold the exact mode's pair set, so its image is the exact
render's. Its projection runs op by op and its bins and blend jitted:
XLA's fusion of a jitted projection moves mean2d by up to 1e-5 px, and
so the image by up to ~5e-6 and, on one orbit frame here, a pixel
across α_min (3.7e-4); so it is within ~2.4e-7 of the port's."""

import importlib.util
import os

import jax
import numpy as np

import gsjax
from gsjax.render.binning import build_tile_bins as j_build_tile_bins
from gsjax.render.composite import composite_tiles as j_composite_tiles
from gsjax.render.project import project as j_project

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the apps' sizes here: the reference's fields of view at 96 pixels wide
N = 400
W, H = 96, 64
FX_VIEW = 500.0 * W / 640  # simple_viewer, file_loader, transformations, camera_updates
FX_FIT = 120.0 * W / 128  # train_fit
SHARD_W, SHARD_H, SHARD_BANDS = 96, 128, 8
FX_SHARD = 400.0 * SHARD_W / 512  # sharded_render
# the reference example's views (examples/file_loader.py and the others)
EYE, AT = (0.0, -1.0, -1.0), (0.0, 0.0, 4.0)
J_CFG = gsjax.RenderConfig(backend="xla", footprint_clamp=True)


def j_examples_common():
    """examples/_common.py, the reference examples' shared module (it
    puts JAX on the CPU, as the tests run it)."""
    spec = importlib.util.spec_from_file_location(
        "_gsjax_examples_common", os.path.join(ROOT, "examples", "_common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def j_look_at(width=W, height=H, fx=FX_VIEW, eye=EYE):
    return gsjax.Camera.look_at(eye, AT, fx=fx, fy=fx, width=width, height=height)


_J_BLEND = jax.jit(lambda p, cam: j_composite_tiles(p, j_build_tile_bins(p, cam, J_CFG),
                                                    cam, J_CFG))


def j_render(g, cam) -> np.ndarray:
    """gsjax.render(g, cam, J_CFG) (its legacy xla path: project, bins,
    blend), the projection op by op, asserting that its bins clamped and
    dropped nothing."""
    img, aux = _J_BLEND(j_project(g, cam, J_CFG), cam)
    assert int(aux["n_clamped"]) == 0 and int(aux["n_tile_overflow"]) == 0
    return np.asarray(img)[: cam.height, : cam.width]


def assert_splat_close(bp: bytes, bj: bytes):
    """Two .splat files of one scene written by the two packages: the
    positions bit-equal, the scales (exp of the log-scales: torch's and
    XLA's exp differ by an ulp) within 1 ulp, the u8 columns (colour,
    opacity, rotation: rounded activations, where a 1-ulp input may
    cross a .5) within one step on under 1% of the bytes
    (tests/test_torch_io.py's rule)."""
    assert len(bp) == len(bj)
    rp = np.frombuffer(bp, np.uint8).reshape(-1, 32)
    rj = np.frombuffer(bj, np.uint8).reshape(-1, 32)
    np.testing.assert_array_equal(rp[:, :12], rj[:, :12])
    np.testing.assert_array_max_ulp(rp[:, 12:24].copy().view(np.float32),
                                    rj[:, 12:24].copy().view(np.float32), 1)
    d = np.abs(rp[:, 24:].astype(int) - rj[:, 24:].astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 0.01
