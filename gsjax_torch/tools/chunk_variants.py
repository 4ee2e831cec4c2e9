"""Time kernel J (csrc/probe_chunk.cu) under the layouts and groupings its
design chose between: each gather variant in the other gather layout
(a staged, transposed window in shared memory against the shipped lanes
over pair rows reading band in place), and bwdsums with other numbers of
rows per reduce-scatter (1: one warp_sum per value; 2, 8, 16).

    python -m gsjax_torch.tools.chunk_variants [--builds layout-onehot3,rows8+layout-maskwalk,...]

A build is a copy of probe_chunk.cu with its text edited (every edit's
text must occur as often as it expects, so a build never silently times
the shipped kernel; one layout-* edit a build), built into a library of
its own under gsjax_torch/_build/variants, all at once, and swapped in
for the probes library's gsjax_probe_chunk. For each build this prints
ptxas's registers of the J variants it changes, whether they agree with
probe_chunk_plain on the probe's, the random and the two edge inputs
(probe_chunk.agree's tolerances), and their ns per block over base — the
build's own base, timed right before and after each — beside the shipped
kernel's, timed in the same run before and after the builds. Times are
device times of a CUDA graph of launches (tools.time_ms), beside the
card's name and power limit; the last line is a JSON object of the same.
Card only; the shipped library is left as it is.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import re

import torch

from gsjax_torch import kernels
from gsjax_torch.tools import (build_edited, card_line, edit, loaded, ptxas_kernels,
                               time_over_base_ms)
from gsjax_torch.tools import probe_chunk as pj

SOURCE = "probe_chunk.cu"
HEADERS = ("common.cuh", "probe.cuh")
GATHERS = {"onehot3": "kOnehot3", "gatherreal": "kGatherreal",
           "flatgather": "kFlatgather", "maskwalk": "kMaskwalk"}

# The staged layout of a gather, inserted before chunk_kernel:
# band[0:32, the columns the variant can read] copied transposed into
# shared memory (32 columns contiguous per band column; the copy reads
# whole sectors), lanes over columns (thread t owns elements (t / 32 +
# 4e, t mod 32)), so a selected element is a conflict-free shared load
# after a window test of its own.
STAGED = r"""// the band columns a staged gather can read: onehot3 its three windows,
// gatherreal any clamped 128-column window, flatgather and maskwalk a
// window from a 128-aligned start mod 256
template <int V>
__host__ __device__ constexpr int stage_cols() {
  return V == kOnehot3 ? 3 * kWinW : V == kGatherreal ? kBandW : 2 * kWinW;
}

// Copy band[0:32, 0:kStageCols) transposed into stage[x·32 + c]: a thread
// reads 32 contiguous bytes of one band row (two 16-byte loads, so a
// warp's loads fill 32 whole sectors) and writes its 16 values 64 bytes
// apart (lanes over c: 64 contiguous bytes a store).
template <int kStageCols>
__device__ __forceinline__ void stage_window(const unsigned short* __restrict__ band,
                                             unsigned short* stage) {
  constexpr int kPieces = kCols * kStageCols / 16;
  for (int p = threadIdx.x; p < kPieces; p += kThreads) {
    const int c = p & 31, x0 = (p >> 5) * 16;
    const uint4* src = reinterpret_cast<const uint4*>(band + c * kBandW + x0);
    const uint4 a = __ldg(src), b = __ldg(src + 1);
    const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      stage[(x0 + 2 * k) * kCols + c] = static_cast<unsigned short>(w[k] & 0xffffu);
      stage[(x0 + 2 * k + 1) * kCols + c] = static_cast<unsigned short>(w[k] >> 16);
    }
  }
}

// gather_round, or with kStaged its staged form: element e of the thread
// is (warp + 4e, lane), band[c, x] is stage[x·32 + c], each element has
// its own test
template <bool kStaged, class Hit>
__device__ __forceinline__ void gather_round_as(float (&acc)[kPerThread],
                                                const unsigned short* __restrict__ band,
                                                const unsigned short* stage, int start, Hit hit) {
  if constexpr (kStaged) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      unsigned off;
      if (hit(warp + kWarps * e, off)) {
        const int x = start + static_cast<int>(off);
        acc[e] = acc[e] + __uint_as_float(static_cast<unsigned>(stage[x * kCols + lane]) << 16);
      }
    }
  } else {
    gather_round(acc, band, start, hit);
  }
}

"""


def staged(enum: str) -> list:
    """The edits that make gather variant `enum` read a staged window."""
    return [
        (re.escape("gather_round(acc, band, "), "gather_round_as<kStaged>(acc, band, stage, ", 4),
        (re.escape("template <int V>\n__global__"), lambda m: STAGED + m.group(0), 1),
        (re.escape("  __shared__ int ired[32];\n"),
         lambda m: m.group(0) + f"  constexpr bool kStaged = V == {enum};\n"
         "  __shared__ __align__(16) unsigned short stage[kStaged ? kCols * stage_cols<V>() : 2];\n",
         1),
        (re.escape("crow[tid] = floor_div(wadd(id, wmul(s, -9)), 3);\n"),
         lambda m: m.group(0) + "    if constexpr (kStaged) stage_window<stage_cols<V>()>(band, stage);\n",
         1),
    ]


# edit → ([(regex, replacement, matches expected)], the J variants it changes)
EDITS = {
    **{f"layout-{v}": (staged(enum), (v,)) for v, enum in GATHERS.items()},
    **{f"rows{p}": ([(r"constexpr int kBwdRows = \d+;", f"constexpr int kBwdRows = {p};", 1)],
                    ("bwdsums",))
       for p in (1, 2, 8, 16)},
}
BUILDS = ("layout-onehot3,layout-gatherreal,layout-flatgather,layout-maskwalk,"
          "rows1,rows2,rows8,rows16")


def changed(build: str) -> tuple:
    """The J variants a build changes, in VARIANTS order."""
    names = {v for e in build.split("+") for v in EDITS[e][1]}
    return tuple(v for v in pj.VARIANTS if v in names)


def build_library(build: str) -> str:
    """The build's library (built if missing) under _build/variants;
    returns its path."""
    names = build.split("+")
    if sum(n.startswith("layout-") for n in names) > 1:
        raise ValueError(f"{build}: one layout-* edit a build")
    with open(os.path.join(kernels.CSRC, SOURCE)) as fh:
        text = edit(build, fh.read(), [e for n in names for e in EDITS[n][0]])
    return build_edited(f"j-{build}", {SOURCE: text}, HEADERS)


def registers(path: str) -> dict:
    """{J variant: "registers (spill stores bytes)" of its chunk_kernel}
    from the ptxas report beside the library at `path`."""
    out = {}
    for name, p in ptxas_kernels(path):
        m = re.search(r"chunk_kernelILi(\d+)EE", name)
        if m:
            out[pj.VARIANTS[int(m.group(1))]] = (f"{p['registers']} "
                                                 f"({p['spill_stores']} B spilled)")
    return out


def agrees(variant: str, inputs) -> bool:
    """Whether the loaded kernel agrees with the plain version on every
    input (every block the same, but base's)."""
    for rows, band in inputs:
        k, p = pj.probe_chunk(variant, rows, band), pj.probe_chunk_plain(variant, rows, band)
        if not (torch.equal(k, k[:1].expand_as(k)) and pj.agree(variant, k[-1], p[-1])):
            return False
    return True


def over_base_ns(variants, rows, band, dev, reps: int) -> dict:
    """{variant: ns per block over base} for the loaded kernel."""
    out = {}
    for v in variants:
        ms, base = time_over_base_ms(lambda: pj.probe_chunk(v, rows, band),
                                     lambda: pj.probe_chunk("base", rows, band), dev, reps)
        out[v] = (ms - base) / pj.G * 1e6
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--builds", default=BUILDS,
                    help="comma-separated edits joined by '+'; edits: " + ", ".join(EDITS))
    ap.add_argument("--reps", type=int, default=50, help="launches per CUDA graph")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool runs on the card only")
    dev = torch.device("cuda:0")
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}")
    builds = args.builds.split(",")
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        shipped_path = pool.submit(kernels.build, "probes")
        paths = dict(zip(builds, pool.map(build_library, builds)))
    kernels.lib("probes")
    inputs = [pj.probe_inputs(dev), pj.random_inputs(dev), *pj.edge_inputs(dev)]
    rows, band = inputs[0]
    timed = tuple(v for v in pj.VARIANTS if any(v in changed(b) for b in builds))

    out = dict(card=card, builds=[])
    shipped_regs = registers(shipped_path.result())
    before = over_base_ns(timed, rows, band, dev, args.reps)
    for b, path in paths.items():
        with loaded("probes", path, ("gsjax_probe_chunk",)):
            vs = changed(b)
            row = dict(build=b, registers={v: registers(path)[v] for v in vs},
                       agree=all(agrees(v, inputs) for v in vs),
                       ns_over_base=over_base_ns(vs, rows, band, dev, args.reps))
        out["builds"].append(row)
        print(f"{b}: ns per block over base {_fmt(row['ns_over_base'])} on {card}; registers "
              f"{row['registers']}; {'agree' if row['agree'] else 'DIFFER'} with the plain "
              "versions (probe, random and both edge inputs)")
    after = over_base_ns(timed, rows, band, dev, args.reps)
    out["shipped"] = dict(registers={v: shipped_regs[v] for v in timed},
                          ns_over_base_before=before, ns_over_base_after=after)
    print(f"shipped: ns per block over base {_fmt(before)} before the builds, {_fmt(after)} "
          f"after, on {card}; registers {out['shipped']['registers']}")
    print(json.dumps(out))
    return 0 if all(r["agree"] for r in out["builds"]) else 1


def _fmt(d: dict) -> dict:
    return {k: round(x, 2) for k, x in d.items()}


if __name__ == "__main__":
    raise SystemExit(main())
