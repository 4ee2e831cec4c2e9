"""J: the per-op cost of one blend chunk (tools/probe_chunk.py) on Hopper.

Each of 17 variants runs one sub-op of a chunk — 128 pair rows against
256 pixels — in G blocks of 128 threads, two pixels a thread, the way
kernels C-F run it now: the pixel variants load a row's two pixels in one
32-bit word, bwdsums sums four rows' six values over a warp's pixels in
one reduce-scatter, banddyn reads its column runs along the run, and the
gathers read band rows in place with lanes over pair rows. `base` runs
the same block shape, so a variant's time over `base`, per block, is
that op's cost. Every block writes the value the probe writes and a
checksum of all the elements its variant computed (so the compiler
keeps the work). Details per variant in
csrc/probe_chunk.cu; `python -m gsjax_torch.tools.chunk_variants` times
the other layouts and groupings.

    python -m gsjax_torch.tools.probe_chunk [v1,v2,...] [--device cpu]
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gsjax_torch import kernels
from gsjax_torch.render.fastmath import _fexp_poly
from gsjax_torch.tools import device_parser, open_device, time_ms, time_over_base_ms

CHUNK = 128
N_PX = 256
LANES = 256
WINW = 128
BAND_W = 512
G = 4096
VARIANTS = ("base", "roll", "swapaxes", "decode", "onehot3", "scatter3", "alpha",
            "hs_prod", "dots", "bwdsums", "fori0", "when_f", "banddyn", "gatherreal",
            "dynread", "flatgather", "maskwalk")
# the variants whose value is a floating-point sum taken in another order
# than the probe's (a log-step product, the MXU's dot, lane reductions):
# within 1e-6 relative of the probe. Every other value is bit-equal.
FLOAT_SUMS = ("hs_prod", "dots", "bwdsums")
GATHERS = ("onehot3", "gatherreal", "flatgather", "maskwalk")  # acc from band loads a round
MASKS = (0x13, 0x0B, 0x26)  # maskwalk's masks (`x % 1 | mask`)
VALUE_RTOL = 1e-6
# the checksum of a variant with floating-point elements sums 4k-33k of
# them in the kernel's block order against the plain version's: within
# 1e-4 relative. Checksums of integer elements, and of dyadic sums short
# enough to be exact in f32 (the probe's inputs), are bit-equal.
FLOAT_CHECKSUMS = ("alpha",) + FLOAT_SUMS
CHECKSUM_RTOL = 1e-4


def _floor_div(a, d):
    return torch.div(a, d, rounding_mode="floor")


def _wrap(x: int) -> int:
    """A Python int wrapped to int32."""
    return (x + 2**31) % 2**32 - 2**31


def _decode(r0):
    """sid = id // 9 and crow = (id mod 9) // 3 of the chunk's 128 ids."""
    ids = r0[:CHUNK]
    sid = _floor_div(ids, 9)
    return sid, _floor_div(ids - sid * 9, 3)


def _selected(band32, hit, start: int, off):
    """acc [128, 32] contribution of one window: element (i, c) the band
    value at column start + off[i] of row c where hit[i], else 0."""
    col = (start + off.clamp(0, WINW - 1)).clamp(0, BAND_W - 1)
    return torch.where(hit[:, None], band32[:32, col].T, 0.0)


def _window(sid, base: int):
    """(whether sid lies in the 128-lane window from base, with int32
    wrap-around; its offset in the window)."""
    off = torch.remainder(sid - base, 2**32)
    return off < WINW, off


def _chunk_values(variant: str, rows, band):
    """The probe's value and the checksum for one block (all blocks but
    base's compute the same)."""
    r0 = rows[0].to(torch.int64)
    s = [int(x) for x in r0[:5]]  # the scalars the probe reads
    band32 = band.float()
    dev = rows.device
    if variant == "roll":
        raw = r0[(torch.arange(LANES, device=dev) + s[0] % 64) % LANES]
        return float(raw[0]), float(_wrap(int(raw.sum())))
    if variant == "swapaxes":
        return float(r0[0]), float(_wrap(int(r0[:CHUNK].sum())))
    if variant == "decode":
        raw = r0[(torch.arange(CHUNK, device=dev) + s[0] % 64) % LANES]
        sid = _floor_div(raw, 9)
        crow = torch.where(torch.arange(CHUNK, device=dev) < 100,
                           _floor_div(raw - sid * 9, 3), -1)
        return (float(_wrap(int(sid[0] + crow[5]))),
                float(_wrap(int((sid + crow).sum()))))
    if variant in ("fori0", "when_f"):
        nr = s[1] % 1  # data-dependent 0: the loops run, the branches fire, never
        acc = float(sum(w for _ in range(3) for w in range(1, 1 + nr)))
        return (acc, acc) if variant == "fori0" else (float(nr), float(nr))
    if variant == "dynread":
        acc = _wrap(int(r0[128:128 + s[1] % 1 + 10].sum()))
        return float(acc), float(acc)
    if variant == "scatter3":
        sid, crow = _decode(r0)
        cnt = torch.zeros(3 * WINW, dtype=torch.float32, device=dev)
        for r in range(3):
            hit, off = _window(sid, _wrap(int(sid[r]) // WINW * WINW))
            hit &= crow == r
            cnt.index_add_(0, r * WINW + off[hit], torch.ones(int(hit.sum()), device=dev))
        win = 0.0 + (cnt + cnt)  # scr[c, window] for each of its 16 rows c
        return float(win[0]), float(win.double().sum() * 16)
    if variant == "alpha":
        att = band32[:, 0:4]
        px = torch.arange(N_PX, device=dev, dtype=torch.float32)
        dx = px[None, :] - att[:, 0:1]
        power = -0.5 * (att[:, 1:2] * dx * dx + att[:, 2:3] * dx) - dx
        alpha = torch.clamp(att[:, 3:4] * _fexp_poly(power), max=0.99)
        return float(alpha[0, 0]), float(alpha.double().sum())
    if variant == "hs_prod":
        incl = torch.cumprod(1.0 - band32[:, :N_PX] * 1e-6, dim=0)
        return float(incl[0, 0]), float(incl.double().sum())
    if variant == "dots":
        w = band32[:, :N_PX]
        img = band32[:, 0:3].T @ w
        wmax = w.max()
        return float(img[0, 0] + wmax), float(img.double().sum() + wmax)
    if variant == "bwdsums":
        x = band32[:, :N_PX]
        d = x * 0.5
        s1, s2 = (x * d).sum(dim=1), (x * d * d).sum(dim=1)
        acc = torch.zeros(CHUNK, device=dev)
        for _ in range(3):
            acc = acc + s1
            acc = acc + s2
        return float(acc[0]), float(acc.double().sum())

    # banddyn and the gather variants: acc [CHUNK, 32]
    acc = torch.zeros((CHUNK, 32), dtype=torch.float32, device=dev)
    if variant == "banddyn":
        for r in range(3):
            start = s[r] % 3 * WINW
            acc = acc + band32[:32, start:start + WINW].sum(dim=1)[None, :]
    elif variant in GATHERS:
        for hit, start, off in _gather_rounds(variant, r0):
            acc = acc + _selected(band32, hit, start, off)
    else:
        raise ValueError(f"probe_chunk: unknown variant {variant!r}")
    return float(acc[0, 0]), float(acc.double().sum())


def _gather_rounds(variant: str, r0):
    """The rounds of a gather variant on the chunk's ids r0 (int64), in the
    probe's order: (hit [CHUNK] bool, start, off) — where hit[i], element
    (i, c) of acc adds band[c, start + off[i]]."""
    sid, crow = _decode(r0)
    s = [int(x) for x in r0[:5]]
    if variant == "onehot3":
        for r in range(3):
            hit, off = _window(sid, _wrap(int(sid[r]) // WINW * WINW))
            yield hit & (crow == r), r * WINW, off
    elif variant == "gatherreal":
        end = s[3] % 512 + 512
        for r in range(3):
            lo = s[r] % 3 * WINW
            for w in range(s[4] % 1 + 1):
                b = lo + w * WINW
                hit, off = _window(sid, b)
                yield hit & (crow == r) & (b + WINW <= end), min(max(b, 0), BAND_W - WINW), off
    elif variant == "flatgather":
        for k in range(s[1] % 1 + 10):
            desc = int(r0[128 + k])
            lo = _wrap((desc >> 4) * WINW)
            start = lo % 256
            hit, off = _window(sid, lo)
            hit &= (crow == (desc & 15)) & (start + WINW <= BAND_W)
            yield hit, min(max(start, 0), BAND_W - WINW), off
    elif variant == "maskwalk":
        m = list(MASKS)  # `x % 1 | mask`: the data-dependent masks
        los = [s[r] % 2 * WINW for r in range(3)]
        for _ in range(s[4] % 1 + 9):
            rc = 0 if m[0] else (1 if m[1] else 2)
            low = m[rc] & -m[rc]
            pos = low.bit_length() - 1 if low else 31  # the probe's ctz
            b = los[rc] + pos * WINW
            hit, off = _window(sid, b)
            yield hit & (crow == rc), b % 256, off
            m[rc] &= m[rc] - 1


def gather_selections(variant: str, rows: torch.Tensor) -> tuple[int, int]:
    """(rounds, pair rows selected summed over the rounds) of a gather
    variant on `rows`: its function tests each of the chunk's 128 pair
    rows once a round and adds a band value to each of a selected row's
    32 elements."""
    rounds = list(_gather_rounds(variant, rows[0].to(torch.int64)))
    return len(rounds), sum(int(hit.sum()) for hit, _, _ in rounds)


def probe_chunk_plain(variant: str, rows: torch.Tensor, band: torch.Tensor,
                      g: int = G) -> torch.Tensor:
    """Plain PyTorch version of probe_chunk (same contract). Every block
    but base's computes the same chunk, so it is computed once."""
    if variant == "base":
        j = torch.arange(g, dtype=torch.float32, device=rows.device)
        return torch.stack([j, j], dim=1)
    if variant not in VARIANTS:
        raise ValueError(f"probe_chunk: unknown variant {variant!r}")
    v, cs = _chunk_values(variant, rows, band)
    return torch.tensor([v, cs], dtype=torch.float32, device=rows.device).expand(g, 2).clone()


def probe_chunk(variant: str, rows: torch.Tensor, band: torch.Tensor,
                g: int = G) -> torch.Tensor:
    """Probe J: out [g, 2] f32, block j's (value the probe writes,
    checksum of the variant's elements); rows [8, 256] int32 (the chunk's
    ids in row 0), band [128, 512] bf16. Every row is the same but base's
    (row j holds j); the probe's o[0, 0] is out[g − 1, 0].

    Kernel J, csrc/probe_chunk.cu; replaces the TPU kernel
    tools/probe_chunk.py::kernel. CPU tensors take the plain version;
    CUDA tensors launch the kernel (there is no fallback)."""
    if variant not in VARIANTS:
        raise ValueError(f"probe_chunk: unknown variant {variant!r}")
    if rows.device.type == "cpu":
        return probe_chunk_plain(variant, rows, band, g)
    if (rows.device.type != "cuda" or band.device != rows.device
            or rows.dtype != torch.int32 or tuple(rows.shape) != (8, LANES)
            or band.dtype != torch.bfloat16 or tuple(band.shape) != (CHUNK, BAND_W)):
        raise ValueError("probe_chunk: expected rows int32 [8, 256] and band bf16 "
                         f"[128, 512] on one cuda device, got {rows.dtype} "
                         f"{tuple(rows.shape)}, {band.dtype} {tuple(band.shape)}")
    rows, band = rows.contiguous(), band.contiguous()
    out = torch.empty((g, 2), dtype=torch.float32, device=rows.device)
    err = kernels.lib("probes").gsjax_probe_chunk(
        VARIANTS.index(variant), rows.data_ptr(), band.data_ptr(), g, out.data_ptr(),
        kernels.stream_ptr(rows))
    kernels.check(err, "probe_chunk")
    kernels.LAUNCHES["probe_chunk"] += 1
    return out


def agree(variant: str, got, want) -> bool:
    """Whether a block's (value, checksum) pair agrees with the reference
    pair within the variant's tolerance (bit-equal, or VALUE_RTOL /
    CHECKSUM_RTOL relative)."""
    (v, cs), (v0, cs0) = (float(got[0]), float(got[1])), (float(want[0]), float(want[1]))
    ok_v = abs(v - v0) <= VALUE_RTOL * abs(v0) if variant in FLOAT_SUMS else v == v0
    if variant in FLOAT_CHECKSUMS:
        return ok_v and abs(cs - cs0) <= CHECKSUM_RTOL * abs(cs0)
    return ok_v and cs == cs0


def probe_inputs(device):
    """The probe's own inputs: every row of rows arange(256)·7 mod 1152,
    band all ones."""
    rows = (torch.arange(LANES, dtype=torch.int32, device=device) * 7 % 1152).repeat(8, 1)
    return rows, torch.ones((CHUNK, BAND_W), dtype=torch.bfloat16, device=device)


def _dyadic_band(rng) -> np.ndarray:
    """A dyadic band (k/8, |k| ≤ 16) with integer means in column 0,
    positive x² coefficients in column 1 and opacities in (0, 1] in
    column 3, so the gather sums are exact in f32 in any order; band[0, 0]
    is 2, so pixel 0 lies near pair 0's mean (alpha[0, 0] is no
    underflow)."""
    band = rng.integers(-16, 17, (CHUNK, BAND_W)) / 8.0
    band[:, 0] = rng.integers(0, 256, CHUNK)
    band[0, 0] = 2.0
    band[:, 1] = rng.integers(1, 17, CHUNK) / 8.0
    band[:, 3] = rng.integers(1, 17, CHUNK) / 16.0
    return band


def _on(device, rows: np.ndarray, band: np.ndarray):
    return (torch.from_numpy(rows.astype(np.int32)).to(device),
            torch.from_numpy(band.astype(np.float32)).to(device, torch.bfloat16))


def random_inputs(device):
    """Random inputs of the probe's shapes from a numpy seed: ids with
    negative values (jnp's floor division and modulo); a dyadic band
    (_dyadic_band); pair 0 (sid 40, class row 0) inside the windows the
    gather variants select and pair 7 on lane 0 of scatter3's, so the
    values the probe writes are not 0."""
    rng = np.random.default_rng(13)
    rows = rng.integers(-1200, 1200, (8, LANES)).astype(np.int32)
    rows[0, 128:138] = rng.integers(-24, 24, 10)  # flatgather's descriptors
    rows[0, 0], rows[0, 7], rows[0, 128] = 9 * 40, 1, 0
    return _on(device, rows, _dyadic_band(rng))


I32_MIN, I32_MAX = -2**31, 2**31 - 1
# lane 0 (a sid) of class row r's window in edge_inputs: low in sid's
# range, near its top (238,609,294) and near its floor (−238,609,295),
# where an id at offset 127 and one at −1 or 128 still fit in int32
EDGE_WINDOWS = (128, 238_609_152, -238_609_280)
# the window below EDGE_WINDOWS[2], which holds the sid of I32_MIN and
# I32_MIN + 1 (offset 113; only offsets 113-127 hold ids in int32)
FLOOR_WINDOW = -238_609_408


def _id(sid: int, crow: int, k: int = 0) -> int:
    """The id 9·sid + 3·crow + k (k < 3), which decodes to (sid, crow)."""
    return 9 * sid + 3 * crow + k


def _desc(lo: int, cls: int, top: bool = True) -> int:
    """A flatgather descriptor for class row cls whose window starts at lo
    (a multiple of 128, as int32); top sets bit 31, which the probe's
    (desc >> 4)·128 wraps away."""
    d = ((lo // WINW) % 2**25) << 4 | cls
    return _wrap(d | 2**31) if top else d


def edge_inputs(device) -> list:
    """Two inputs (rows, band) at the edges of the probe's integer
    arithmetic, from a numpy seed, which differ in the two ids that decide
    most of the values the probe writes. The gathers write acc[0, 0],
    pair 0's element, so one pair 0 cannot show every gather an edge:
    gatherreal's and maskwalk's windows lie in [0, 896), where no extreme
    id reaches.

    Both: ids at the int32 extremes (floor_div of the most negative ids;
    I32_MIN and I32_MIN + 1, whose class row 2 needs the wrap-around of
    wmul(sid, −9)); each class row's window (EDGE_WINDOWS: low, near the
    top and near the floor of sid's range) with pairs of that class row at
    offsets 0 and 127, and just outside at −1 and 128, likewise for
    gatherreal's and maskwalk's windows; rows[0, 3:5] the extremes
    (gatherreal's end, the `x % 1` counts). flatgather's descriptors reach
    bit 31 and wrap: (desc >> 4)·128 of a descriptor with bit 31 set, and
    windows at −1024, near 2^31, near sid's floor and at FLOOR_WINDOW (class
    row 2). maskwalk's masks cannot reach bit 31: the probe makes them
    `x % 1 | mask`, constants whatever the input (MASKS); its input is the
    window offsets `x % 2` of the extreme ids. The band is dyadic, as
    random_inputs' (_dyadic_band).

    The first: pair 0 at offset 127 of class row 0's low window, which
    onehot3, gatherreal, maskwalk and flatgather (a descriptor with bit 31
    set) all select, and scatter3's lane 0 hit; roll and decode read
    I32_MAX and I32_MIN + 1 (rows[0, 56], rows[0, 61]: the shift rows[0, 0]
    mod 64 is 56). The second: pair 0 is I32_MIN and pair 2 sits in its
    window, FLOOR_WINDOW, so onehot3 and flatgather write the element of an
    id whose class row needs the wrap-around, in the lowest window; roll
    (shift 0) reads I32_MIN, decode sid(I32_MIN) + crow(I32_MIN + 1)."""
    rng = np.random.default_rng(15)
    rows = rng.integers(I32_MIN, I32_MAX + 1, (8, LANES), dtype=np.int64)
    ids = [_id(EDGE_WINDOWS[0] + 127, 0, 1), _id(EDGE_WINDOWS[1], 1), _id(EDGE_WINDOWS[2], 2, 2),
           I32_MIN, I32_MAX, I32_MIN + 1, I32_MAX - 1, -1, 0, I32_MIN + 9, I32_MAX - 9]
    for r, b in enumerate(EDGE_WINDOWS):  # onehot3's and scatter3's windows
        ids += [_id(b + o, r, o % 3) for o in (0, 127, -1, 128)]
    for r in range(3):  # gatherreal's: from (x % 3)·128
        lo = ids[r] % 3 * WINW
        ids += [_id(lo + o, r, 2) for o in (0, 127, -1, 128)]
    for r, mask in enumerate(MASKS):  # maskwalk's: from (x % 2)·128 + ctz·128
        lo = ids[r] % 2 * WINW
        for pos in (p for p in range(32) if mask >> p & 1):
            ids += [_id(lo + pos * WINW, r), _id(lo + pos * WINW + 127, r, 2)]
    ids += [_id(-1024, 0), _id(-1024 + 127, 0, 2)]  # flatgather's window at −1024
    rows[0, :len(ids)] = ids
    rows[0, len(ids):CHUNK] = rng.integers(-3000, 3000, CHUNK - len(ids))
    sh = ids[0] % 64  # roll's and decode's shift
    assert sh >= len(ids)
    rows[0, sh], rows[0, sh + 5] = I32_MAX, I32_MIN + 1
    rows[0, 128:138] = [_desc(EDGE_WINDOWS[0], 0), _desc(EDGE_WINDOWS[1], 1),
                        _desc(EDGE_WINDOWS[2], 2), I32_MIN, I32_MAX, -1,
                        _desc(EDGE_WINDOWS[0], 0, top=False), _desc(-1024, 0),
                        _desc(FLOOR_WINDOW, 2), _desc(2**31 - WINW, 1)]
    band = _dyadic_band(rng)
    floor = rows.copy()
    floor[0, 0], floor[0, 2] = I32_MIN, _id(FLOOR_WINDOW + 127, 2, 2)
    assert rows.min() >= I32_MIN and rows.max() <= I32_MAX
    return [_on(device, rows, band), _on(device, floor, band)]


def main(argv=None) -> None:
    ap = device_parser(__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="?", default=",".join(VARIANTS[1:]),
                    help="comma-separated variants (base always runs first)")
    ap.set_defaults(reps=50)
    args = ap.parse_args(argv)
    dev = open_device(args.device)
    rows, band = probe_inputs(dev)
    base_fn = functools.partial(probe_chunk, "base", rows, band)
    print(f"  {'base':10s}: {time_ms(base_fn, dev, args.reps):7.4f} ms total")
    for v in args.variants.split(","):
        ms, base = time_over_base_ms(lambda: probe_chunk(v, rows, band), base_fn, dev,
                                     args.reps)
        print(f"  {v:10s}: {ms:7.4f} ms total, {(ms - base) / G * 1e6:8.2f} "
              f"ns/step over base (base {base:.4f} ms, timed beside it)")


if __name__ == "__main__":
    main()
