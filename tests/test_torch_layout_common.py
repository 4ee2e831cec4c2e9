"""Helpers of the layout kernels' tests (test_torch_layout_*.py): random
home rows and numpy emulations of kernels A's and B's index logic."""

import numpy as np
import torch

from gsjax_torch.render import binning as tbin
from gsjax_torch.render.homesort import HomeLayout
from gsjax_torch.render.project import ProjectedSplats

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
