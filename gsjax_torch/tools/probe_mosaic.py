"""G: the Mosaic-primitives probe (tools/probe_mosaic.py) on Hopper.

On x [8, 2048] int32: a lane roll by a data-dependent amount, a dynamic
128-lane slice of row 3 and its transpose, a while loop with a reduced
exit test, and one bitonic compare-exchange substage at distance 16
(details in csrc/probe_mosaic.cu). Returns the probe's row 3 of o and
s = Σz.

    python -m gsjax_torch.tools.probe_mosaic [--device cpu]
"""

from __future__ import annotations

import torch

from gsjax_torch import kernels
from gsjax_torch.tools import device_parser, open_device, time_ms, wrap_int32

CAP = 2048
ROWS = 8
LOOP_MAX = 10**9


def probe_mosaic_plain(x: torch.Tensor):
    """Plain PyTorch version of probe_mosaic (same contract)."""
    amt = int(x[0, 0]) % 1024  # Python's % is jnp's floor modulo
    k = int(x[0, 2]) % (CAP // 128)
    y = torch.roll(x, amt, 1)  # pltpu.roll's direction is np.roll's
    col = y[3, k * 128:(k + 1) * 128].to(torch.int64)
    acc = col.clone()
    for _ in range(4):
        if int(wrap_int32(acc).max()) >= LOOP_MAX:
            break
        acc = acc + col
    lane = torch.arange(CAP, device=x.device)
    partner = y[:, lane ^ 16]
    gt = (y > partner) | ((y == partner) & (lane > (lane + 16) % CAP))
    z = torch.where(gt, partner, y).to(torch.int64)
    o = wrap_int32(z[0, :128] + acc[0] + z[1].sum())
    return o, wrap_int32(z.sum().reshape(1))


def probe_mosaic(x: torch.Tensor):
    """Probe G on x [8, 2048] int32 → (o [128] int32, the probe's row 3 of
    o; s [1] int32, Σz), every sum wrapping in int32.

    Kernel G, csrc/probe_mosaic.cu; replaces the TPU kernel
    tools/probe_mosaic.py::kernel. CPU tensors take the plain version;
    CUDA tensors launch the kernel (there is no fallback)."""
    if x.device.type == "cpu":
        return probe_mosaic_plain(x)
    if x.device.type != "cuda" or x.dtype != torch.int32 or tuple(x.shape) != (ROWS, CAP):
        raise ValueError(f"probe_mosaic: expected int32 [{ROWS}, {CAP}] on cuda, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel stages x with one 16-byte aligned bulk copy
        x = x.clone()
    o = torch.empty(128, dtype=torch.int32, device=x.device)
    s = torch.empty(1, dtype=torch.int32, device=x.device)
    err = kernels.lib("probes").gsjax_probe_mosaic(x.data_ptr(), o.data_ptr(),
                                                   s.data_ptr(), kernels.stream_ptr(x))
    kernels.check(err, "probe_mosaic")
    kernels.LAUNCHES["probe_mosaic"] += 1
    return o, s


def probe_input(device) -> torch.Tensor:
    """The probe's own input: arange(8·2048) as [8, 2048]."""
    return torch.arange(ROWS * CAP, dtype=torch.int32, device=device).reshape(ROWS, CAP)


def main(argv=None) -> None:
    args = device_parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = open_device(args.device)
    x = probe_input(dev)
    o, s = probe_mosaic(x)
    print("probe ok:", int(o.to(torch.int64).sum()), int(s[0]))
    ms = time_ms(lambda: probe_mosaic(x), dev, args.reps)
    print(f"probe_mosaic: {ms:.4f} ms per call ({args.device})")


if __name__ == "__main__":
    main()
