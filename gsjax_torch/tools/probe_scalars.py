"""I: the per-block cost of a block's index scalars (tools/probe_scalars.py)
on Hopper.

Each of G blocks gets six int32 scalars and sums them: `smem` from a table
in global memory (stab[6j .. 6j+5], the TPU's scalar prefetch), `vmem`
from its own row (rows[j, 248 .. 253]), `reduce` as three masked min / max
pairs over its row's first 128 ids; `base` only writes. The time of each
over `base`, per block, is the cost of that source.

    python -m gsjax_torch.tools.probe_scalars [--device cpu]
"""

from __future__ import annotations

import functools

import torch

from gsjax_torch import kernels
from gsjax_torch.tools import (device_parser, open_device, time_ms, time_over_base_ms,
                               wrap_int32)

CHUNK = 128
LANES = 256
G = 8192
VARIANTS = ("base", "smem", "vmem", "reduce")
EMPTY_MIN = 2**30  # the min of a class with no id


def probe_scalars_plain(variant: str, stab: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of probe_scalars (same contract)."""
    g = rows.shape[0]
    if variant == "base":
        return torch.zeros(g, dtype=torch.int32, device=rows.device)
    if variant == "smem":
        six = stab[: 6 * g].view(g, 6)
    elif variant == "vmem":
        six = rows[:, 248:254]
    elif variant == "reduce":
        ids = rows[:, :CHUNK].to(torch.int64)
        cls = torch.remainder(ids, 3)
        six = torch.stack(
            [torch.where(cls == r, ids, EMPTY_MIN).amin(dim=1) for r in range(3)]
            + [torch.where(cls == r, ids, -1).amax(dim=1) for r in range(3)], dim=1)
    else:
        raise ValueError(f"probe_scalars: unknown variant {variant!r}")
    return wrap_int32(six.to(torch.int64).sum(dim=1))


def probe_scalars(variant: str, stab: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Probe I: out [G] int32, block j's sum of its six scalars (wrapping);
    stab [G·6] int32, rows [G, 256] int32. The probe's o[0, 0] is out[G−1]
    (on the TPU the last grid step wins).

    Kernel I, csrc/probe_scalars.cu; replaces the TPU kernel
    tools/probe_scalars.py::kernel. CPU tensors take the plain version;
    CUDA tensors launch the kernel (there is no fallback)."""
    if variant not in VARIANTS:
        raise ValueError(f"probe_scalars: unknown variant {variant!r}")
    if rows.device.type == "cpu":
        return probe_scalars_plain(variant, stab, rows)
    g = rows.shape[0]
    if (rows.device.type != "cuda" or stab.device != rows.device
            or rows.dtype != torch.int32 or stab.dtype != torch.int32
            or rows.dim() != 2 or rows.shape[1] < 254 or stab.numel() < 6 * g):
        raise ValueError("probe_scalars: expected int32 stab [G·6] and rows [G, ≥254] "
                         f"on one cuda device, got {tuple(stab.shape)}, {tuple(rows.shape)}")
    stab, rows = stab.contiguous(), rows.contiguous()
    out = torch.empty(g, dtype=torch.int32, device=rows.device)
    err = kernels.lib("probes").gsjax_probe_scalars(
        VARIANTS.index(variant), stab.data_ptr(), rows.data_ptr(), g, rows.shape[1],
        out.data_ptr(), kernels.stream_ptr(rows))
    kernels.check(err, "probe_scalars")
    kernels.LAUNCHES["probe_scalars"] += 1
    return out


def probe_inputs(g: int, device):
    """The probe's own inputs: stab = arange(6G), every row arange(256)."""
    stab = torch.arange(6 * g, dtype=torch.int32, device=device)
    rows = torch.arange(LANES, dtype=torch.int32, device=device).repeat(g, 1)
    return stab, rows


def main(argv=None) -> None:
    ap = device_parser(__doc__.splitlines()[0])
    ap.set_defaults(reps=50)
    args = ap.parse_args(argv)
    dev = open_device(args.device)
    stab, rows = probe_inputs(G, dev)
    base_fn = functools.partial(probe_scalars, "base", stab, rows)
    for v in VARIANTS:
        last = int(probe_scalars(v, stab, rows)[-1])
        if v == "base":
            ms = base = time_ms(base_fn, dev, args.reps)
        else:
            ms, base = time_over_base_ms(lambda: probe_scalars(v, stab, rows), base_fn,
                                         dev, args.reps)
        print(f"  {v:7s}: {ms:7.4f} ms  ({ms / G * 1e6:6.1f} ns/step, "
              f"{(ms - base) / G * 1e6:6.2f} ns/step over base; o[0,0] = {last})")


if __name__ == "__main__":
    main()
