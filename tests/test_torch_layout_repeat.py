"""gsjax_torch: kernel A's plain version against its index logic, and
kernel B's refusal of spans it is not built for."""

import numpy as np
import pytest

import gsjax_torch as gt
from gsjax_torch.render import binning as tbin
from gsjax_torch.render import homesort as ths
from gsjax_torch.render.project import project

from test_torch_layout_common import SPAN, TS, _home_rows, _kernel_a_parents


@pytest.mark.parametrize("case", ["overflow", "max_blocks"])
def test_repeat_fat_parents_plain_slots(case):
    """Kernel A's plain version on a projected scene's parent table: more
    copies than fat_cap (overflow: every slot has a parent), or slots past
    nc with a parent at n_ex = fat_max_blocks − 1; each slot's parent as
    the kernel's block search finds it, and the copy rows of the largest
    parent against its blocks decoded in numpy."""
    rng = np.random.default_rng(5)
    n = 96
    means = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(2, 6, n)], -1)
    scales = rng.uniform(0.02, 0.12, (n, 3)) * np.exp(rng.choice([0.0, 2.5], n))[:, None]
    quats = rng.normal(size=(n, 4))
    sh = rng.normal(size=(n, 1, 3)) * 0.3
    g = gt.Gaussians.from_activated(means=means, scales=scales, quats=quats / np.linalg.norm(
        quats, axis=-1, keepdims=True), opacities=rng.uniform(0.05, 0.95, n), sh=sh,
        device="cpu")
    fat_max_blocks = 6
    cam = gt.Camera.create(fx=80.0, fy=80.0, width=160, height=112, device="cpu")
    cfg = gt.RenderConfig(backend="stream", chunk=32, fat_max_blocks=fat_max_blocks,
                          fat_cap=2048 if case == "max_blocks" else 8)
    tiles_x, tiles_y = cfg.tiles_x(cam.width), cfg.tiles_y(cam.height)
    p = project(g, cam, cfg)
    g18, fb, fbe, n_copies = ths.fat_repeat_inputs(p, tiles_x, tiles_y, cfg)
    n_copies = int(n_copies)
    fat_cap = ths.resolve_fat_caps(n, cfg)[0] if case == "max_blocks" else 8
    nc = min(n_copies, fat_cap)
    n_ex = g18[:, 17].numpy().astype(int)
    assert n_ex.max() == fat_max_blocks - 1
    if case == "overflow":
        assert n_copies > fat_cap and nc == fat_cap
    else:
        assert n_copies < fat_cap
    tail, keys = ths.repeat_fat_parents(g18, fb, fbe, n_copies, fat_cap, tiles_x, tiles_y,
                                        SPAN, TS, cfg.alpha_min)
    assert tail.shape == (fat_cap, 12) and keys.shape == (4, fat_cap)
    par, has = ths.slot_parents(fb, fbe, nc, fat_cap)
    assert bool(has[:nc].all()) and not bool(has[nc:].any())
    for slots in (256, 128, 4):  # the shipped block, a variant's, and many blocks
        k_par, k_has = _kernel_a_parents(fb.numpy(), fbe.numpy(), nc, fat_cap, slots)
        np.testing.assert_array_equal(k_has, has.numpy())
        np.testing.assert_array_equal(k_par[k_has], par.numpy()[k_has])
    t_sent = tiles_x * tiles_y
    assert (tail[nc:] == 0).all() and (keys[0, nc:] == t_sent).all()
    assert (keys[1, nc:] == 1.0).all()
    # the largest parent: its copy slots are its blocks 1..n_ex in row-major
    # order over its rect, each windowed to block ∩ rect
    i = int(np.argmax(n_ex))
    x0, y0, x1, y1 = (int(v) for v in g18[i, 13:17])
    sbx, base = int(g18[i, 12]), int(g18[i, 0])
    for b in range(1, n_ex[i] + 1):
        j = base + b - 1
        if j >= nc:
            break
        bx, by = b % sbx, b // sbx
        wx0, wy0 = x0 + SPAN * bx, y0 + SPAN * by
        wx1, wy1 = min(wx0 + SPAN, x1), min(wy0 + SPAN, y1)
        assert keys[2, j] == wx0 * 16384 + wx1 and keys[3, j] == wy0 * 16384 + wy1, (b, j)
        home = min(wy0 + SPAN // 2, tiles_y - 1) * tiles_x + min(wx0 + SPAN // 2, tiles_x - 1)
        assert keys[0, j] in (home, t_sent)  # culled copies carry the sentinel
        row = g18[i, [1, 2, 7, 3, 4, 5, 8, 9, 10, 11, 6]].numpy()
        np.testing.assert_array_equal(tail[j].numpy(), np.r_[row, 0.0].astype(np.float32))


@pytest.mark.parametrize("span", [2, 17])
def test_launch_expand_rejects_spans_it_is_not_built_for(span):
    """Kernel B is built for the odd spans 1 to 15; any other span is
    refused before the library is touched (the plain version, on the CPU,
    takes any odd span)."""
    p, layout = _home_rows(np.random.default_rng(8), 40, 6, 5)
    cfg = gt.RenderConfig(backend="pallas", chunk=32, tile_span=span)
    inputs = tbin.expand_inputs(p, layout, cfg)
    with pytest.raises(ValueError, match=f"tile_span {span}"):
        tbin.launch_expand(*inputs, 0, 5, 6, TS, span)
