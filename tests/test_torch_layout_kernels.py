"""The layout kernels' plain versions and the CUDA kernels' algorithms,
on the CPU: kernel B (csrc/expand.cu: the live pairs in pid order and
their sort keys) and kernel A (csrc/repeat.cu: the fat-parent repeat).

The plain versions are held to the pipeline they replace, written out
here in numpy: B's dense class-major expansion, flattened in pid order,
compacted and stably sorted by (tile, depth bits, pid). The kernels'
index logic, which no CPU run can execute, is emulated in numpy from
their sources and held to the plain versions: B's window masks, blocks
of EXPAND_ROWS[span] rows that take their row ranges in any order, the
live masks in 32-bit words, the block
scan, the decoupled look-back and the 16-byte grouped stores; A's 32-ary
warp search, the block's staged run of parents and the search inside it.
No gsjax kernel is called."""

import os

import numpy as np
import pytest
import torch

import gsjax_torch as gt
from gsjax_torch import kernels
from gsjax_torch.render import binning as tbin
from gsjax_torch.render import homesort as ths
from gsjax_torch.render.homesort import HomeLayout
from gsjax_torch.render.project import ProjectedSplats, project
from gsjax_torch.tools import layout_variants

torch.set_num_threads(2)

TS, SPAN = 16, 3


def _home_rows(rng, nh, tiles_x, tiles_y, span=SPAN):
    """Random home rows (ProjectedSplats, HomeLayout) of a layout: homes
    inside the image, windows around them (some empty, some reaching
    past the span's block), ~10% dead rows, conics of all sizes and
    orientations, ties in depth."""
    hx = rng.integers(0, tiles_x, nh)
    hy = rng.integers(0, tiles_y, nh)
    x0 = hx - rng.integers(0, span, nh)
    y0 = hy - rng.integers(0, span, nh)
    win = np.stack([x0, x0 + rng.integers(0, span + 1, nh), y0,
                    y0 + rng.integers(0, span + 1, nh)], -1)
    mean2d = np.stack([(hx + rng.uniform(-1.5, 2.5, nh)) * TS,
                       (hy + rng.uniform(-1.5, 2.5, nh)) * TS], -1)
    s = np.exp(rng.uniform(np.log(0.5), np.log(40.0), (nh, 2)))
    th = rng.uniform(0, np.pi, nh)
    c, sn = np.cos(th), np.sin(th)
    ia, ib = 1 / s[:, 0] ** 2, 1 / s[:, 1] ** 2
    conic = np.stack([c * c * ia + sn * sn * ib, c * sn * (ia - ib), sn * sn * ia + c * c * ib], -1)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    p = ProjectedSplats(
        mean2d=f32(mean2d), depth=f32(rng.choice([2.0, 3.5, 7.25], nh)), conic=f32(conic),
        radius=f32(np.full(nh, 30.0)), rgb=f32(rng.uniform(0, 1, (nh, 3))),
        opacity=f32(rng.uniform(0.002, 1.0, nh)), valid=torch.from_numpy(rng.uniform(size=nh) > 0.1),
    )
    layout = HomeLayout(
        perm=torch.arange(nh), seg_starts=i32(np.zeros(tiles_x * tiles_y + 2)),
        home_x=i32(hx), home_y=i32(hy), win=i32(win), n_valid=i32(nh),
        n_fat_overflow=i32(0), n_copies=i32(0), tiles_x=tiles_x, tiles_y=tiles_y,
    )
    return p, layout


def _old_pipeline(p, layout, ty0, band_rows, tiles_x, cfg):
    """The dense expansion's (tile, depth bits, pid) sort as the port did
    it before kernel B compacted in pid order, in numpy: (pid_sorted,
    tile_sorted, tile_starts)."""
    span = cfg.tile_span
    cols = tbin.expand_cols(p, layout, cfg)
    tile2d = tbin.expand_pairs_plain(cols, ty0, band_rows, tiles_x, TS, span)[0].numpy()
    dbits = p.depth.numpy().view(np.int32)
    tile_flat = tile2d.T.reshape(-1)[: dbits.shape[0] * span * span]
    live = np.nonzero(tile_flat != tbin.INVALID_TILE)[0]
    key = ((tile_flat[live].astype(np.int64) << 32)
           | (dbits[live // (span * span)].astype(np.int64) + 2**31))
    order = np.argsort(key, kind="stable")
    tile_sorted = tile_flat[live][order]
    starts = np.searchsorted(tile_sorted, np.arange(tiles_x * band_rows + 1), side="left")
    return live[order], tile_sorted, starts


def _kernel_b(p, layout, ty0, band_rows, tiles_x, cfg, rng):
    """Kernel B's index logic in numpy: (pid_live, key, live count). The
    cull decisions are the plain version's; the window masks (in 32-bit
    words), the blocks (taken in a random ticket order), their scans, the
    look-back and the grouped stores follow csrc/expand.cu."""
    span = cfg.tile_span
    nh, k, h, rows = p.depth.shape[0], span * span, span // 2, tbin.EXPAND_ROWS[span]
    n_words = -(-k // 32)
    cols = tbin.expand_cols(p, layout, cfg)
    culled = tbin.expand_pairs_plain(cols, ty0, band_rows, tiles_x, TS, span)[0].numpy()
    hx, hy = layout.home_x.numpy(), layout.home_y.numpy()
    w = layout.win.numpy()
    valid = p.valid.numpy()
    dbits = p.depth.numpy().view(np.int32)
    mask = [0] * nh  # Python ints: bit c of mask[i] is class c of row i
    for i in np.nonzero(valid)[0]:
        cx0, cx1 = max(w[i, 0] - hx[i] + h, 0), min(w[i, 1] - hx[i] + h, span)
        cy0 = max(max(w[i, 2], ty0) - hy[i] + h, 0)
        cy1 = min(min(w[i, 3], ty0 + band_rows) - hy[i] + h, span)
        if cx0 < cx1:
            bits = ((1 << int(cx1)) - 1) & ~((1 << int(cx0)) - 1)
            for word in range(n_words):  # the kernel's 32-bit words
                m = 0
                for cy in range(cy0, cy1):
                    o = cy * span - 32 * word
                    if -span < o < 32:
                        m |= (bits << o if o >= 0 else bits >> -o) & 0xFFFFFFFF
                mask[i] |= m << (32 * word)
        window = sum(1 << c for c in range(k)
                     if w[i, 0] <= hx[i] + c % span - h < w[i, 1]
                     and max(w[i, 2], ty0) <= hy[i] + c // span - h < min(w[i, 3], ty0 + band_rows))
        assert mask[i] == window, i
        mask[i] &= sum(1 << c for c in range(k) if culled[c, i] != tbin.INVALID_TILE)
    blocks = -(-nh // rows)
    cap = k * nh
    pid_out, key_out = np.full(cap + 8, -1, np.int64), np.full(cap + 8, -1, np.int64)
    status = [None] * blocks  # (inclusive?, value)
    staged, count = {}, None
    for b in rng.permutation(blocks):  # the blocks' totals, published in ticket order
        r = np.arange(b * rows, min((b + 1) * rows, nh))
        cnt = np.array([bin(mask[i]).count("1") for i in r], int)
        pos = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(int)
        s_pid = np.empty(int(cnt.sum()), np.int64)
        s_key = np.empty_like(s_pid)
        for t, i in enumerate(r):
            q = pos[t]
            for c in range(k):
                if mask[i] >> c & 1:
                    s_pid[q] = i * k + c
                    tile = int((hy[i] + c // span - h - ty0) * tiles_x + hx[i] + c % span - h)
                    s_key[q] = (tile << 32) | (int(dbits[i]) + 2**31)
                    q += 1
        staged[b] = (s_pid, s_key)
        status[b] = (b == 0, int(cnt.sum()))
    for b in rng.permutation(blocks):  # look-backs in any order
        base, end = 0, b - 1
        while True:  # warp 0's window of 32 predecessors
            win32 = [status[e] if e >= 0 else (True, 0) for e in range(end, end - 32, -1)]
            inc = [lane for lane, st in enumerate(win32) if st[0]]
            last = inc[0] if inc else 31
            base += sum(st[1] for st in win32[: last + 1])
            if inc:
                break
            end -= 32
        s_pid, s_key = staged[b]
        total = s_pid.shape[0]
        assert base == sum(staged[e][0].shape[0] for e in range(b))
        status[b] = (True, base + total)
        for g in range(base & ~3, base + total, 4):  # 16-byte groups, partial ends
            for e in range(max(g, base), min(g + 4, base + total)):
                pid_out[e] = s_pid[e - base]
        for g in range(base & ~1, base + total, 2):
            for e in range(max(g, base), min(g + 2, base + total)):
                key_out[e] = s_key[e - base]
        if b == blocks - 1:
            count = base + total
    count = 0 if count is None else count
    return pid_out[:count], key_out[:count], count


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


def _count_le_warp(fb, s):
    """csrc/repeat.cu's count_le_warp: #{i : fb[i] ≤ s}, 32 probes a step."""
    lo, hi = 0, fb.shape[0]
    while hi - lo > 32:
        step = (hi - lo + 31) // 32
        idx = lo + step * np.arange(32)
        le = (idx < hi) & (fb[np.minimum(idx, hi - 1)] <= s)
        k = int(le.sum())
        assert le[:k].all()  # a prefix of the lanes: one ballot's popcount
        if k == 0:
            return lo
        lo += step * (k - 1) + 1
        hi = min(hi, lo - 1 + step)
    idx = lo + np.arange(32)
    return lo + int(((idx < hi) & (fb[np.minimum(idx, max(hi - 1, 0))] <= s)).sum())


def _kernel_a_parents(fb, fbe, nc, fat_cap, slots):
    """Kernel A's parent of each copy slot in numpy: (par, has), as
    csrc/repeat.cu finds it: each block of `slots` slots searches fb for
    its first and last slot below nc, stages that run and searches it."""
    par = np.zeros(fat_cap, np.int64)
    has = np.zeros(fat_cap, bool)
    for s0 in range(0, fat_cap, slots):
        live_end = min(s0 + slots, nc)
        if s0 >= live_end:
            continue
        first = max(_count_le_warp(fb, np.float32(s0)) - 1, 0)
        count = _count_le_warp(fb, np.float32(live_end - 1)) - first
        assert count <= slots  # fb rises strictly over the fat parents
        for j in range(s0, live_end):
            q = int(np.searchsorted(fb[first:first + count], np.float32(j), side="right")) - 1
            if q >= 0 and j < fbe[first + q]:
                par[j], has[j] = first + q, True
    return par, has


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
