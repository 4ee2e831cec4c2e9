"""gsjax_torch: kernel B's plain version and its index logic against the
dense pipeline it replaces, and the layout variants tool."""

import os

import numpy as np
import pytest

import gsjax_torch as gt
from gsjax_torch import kernels
from gsjax_torch.render import binning as tbin
from gsjax_torch.render.homesort import HomeLayout
from gsjax_torch.tools import layout_variants

from test_torch_layout_common import SPAN, TS, _home_rows, _kernel_b, _old_pipeline


@pytest.mark.parametrize("case", ["band", "empty", "ragged", "span7", "span9", "span15"])
def test_expand_live_pairs_plain_matches_the_dense_pipeline(case):
    """Kernel B's plain version and the bins it feeds against the dense
    pipeline it replaces, and kernel B's index logic against the plain
    version: a band below the image's first tile row (ty0 > 0, band_rows
    < tiles_y), no live candidate at all (S = 0), a row count that is no
    multiple of the kernel's block, and the wider spans: 7 (49 classes,
    two mask words), 9 (gsjax's golden flat configuration; 128-row
    blocks) and 15, the widest the kernel is built for (64-row blocks)."""
    seeds = {"band": 1, "empty": 2, "ragged": 3, "span7": 4, "span9": 5, "span15": 6}
    rng = np.random.default_rng(seeds[case])
    span = int(case[4:]) if case.startswith("span") else SPAN
    tiles_x, tiles_y = (9, 7) if span == SPAN else (2 * span + 3, span + 4)
    rows = tbin.EXPAND_ROWS[span]
    nh = {"band": 2 * rows, "empty": 300, "ragged": 3 * rows - 37}.get(case, 2 * rows + 5)
    p, layout = _home_rows(rng, nh, tiles_x, tiles_y, span)
    ty0, band_rows = (2, 3) if case == "band" else (0, tiles_y)
    if case == "empty":  # every window misses its home's 3x3 block
        layout = HomeLayout(**{**layout.__dict__, "win": layout.win + 5})
    cfg = gt.RenderConfig(backend="stream" if span == SPAN else "pallas", chunk=32,
                          tile_span=span)
    pid_live, key = tbin.expand_live_pairs(p, layout, ty0, band_rows, tiles_x, cfg)
    pid_sorted, tile_sorted = tbin.sort_pairs(pid_live, key)
    want_pid, want_tile, want_starts = _old_pipeline(p, layout, ty0, band_rows, tiles_x, cfg)
    np.testing.assert_array_equal(pid_sorted.numpy(), want_pid)
    np.testing.assert_array_equal(tile_sorted.numpy(), want_tile)
    cam = gt.Camera.create(fx=80.0, fy=80.0, width=tiles_x * TS, height=tiles_y * TS,
                           device="cpu")
    bins = tbin.build_tile_bins(p, cam, cfg, ty0=ty0, band_rows=band_rows, anchor="home",
                                layout=layout)
    np.testing.assert_array_equal(bins.pid_sorted.numpy(), want_pid)
    np.testing.assert_array_equal(bins.tile_starts.numpy(), want_starts)
    assert int(bins.n_pairs) == want_pid.shape[0]
    if case == "empty":
        assert pid_live.shape == (0,) and key.shape == (0,)
    else:
        assert 0 < pid_live.shape[0] < nh * span * span
        assert np.unique(key.numpy() >> 32).size > 1
    k_pid, k_key, k_count = _kernel_b(p, layout, ty0, band_rows, tiles_x, cfg, rng)
    assert k_count == pid_live.shape[0]
    np.testing.assert_array_equal(k_pid, pid_live.numpy())
    np.testing.assert_array_equal(k_key, key.numpy())


def test_layout_variants_edit_the_kernels():
    """Every default variant of gsjax_torch.tools.layout_variants edits
    the kernel sources as often as it expects (the tool never times the
    shipped kernel under a variant's name)."""
    for v in layout_variants.VARIANTS.split(","):
        with open(os.path.join(kernels.CSRC, layout_variants.SOURCES[v.split("+")[0]])) as fh:
            src = fh.read()
        assert layout_variants.variant_source(v, src) != src


def test_kernel_constants_match_the_sources():
    """The constants the wrappers and the emulations above take from the
    kernels: B's spans and its rows a block at each, A's slots a block."""
    def read(name):
        with open(os.path.join(kernels.CSRC, name)) as fh:
            return fh.read()
    expand, repeat = read("expand.cu"), read("repeat.cu")
    launches = expand.count("    GSJAX_EXPAND(")
    assert launches == len(tbin.EXPAND_ROWS)
    for span, rows in tbin.EXPAND_ROWS.items():
        assert f"    GSJAX_EXPAND({span}, {rows});" in expand
        assert span % 2 == 1 and rows % 32 == 0 and rows * span * span * 12 <= 227 * 1024
    assert "constexpr int kSlots = 256;" in repeat
