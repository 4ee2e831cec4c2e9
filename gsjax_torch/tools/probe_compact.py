"""H: stream compaction of a class-masked pair stream (tools/probe_compact.py)
on Hopper.

Lanes come in 128-lane subgroups; for each subgroup and each class
c < classes, the lanes whose bit c is set in mask append their 8 values
to the stream, in (subgroup, class, lane) order — the compaction that
would replace the padded pair output of kernel B and the nonzero and sort
after it. The probe's inputs: mask 0x1B5 everywhere (6 of 9 classes
alive), vals = 1, nh = 2.4M cut to a multiple of 2048.

    python -m gsjax_torch.tools.probe_compact [--nh 2400000] [--device cpu]
"""

from __future__ import annotations

import torch

from gsjax_torch import kernels
from gsjax_torch.tools import device_parser, open_device, time_ms

SUB = 128  # lanes per subgroup
R = 2048  # the probe's input rows per grid step: nh is cut to a multiple
VAL_ROWS = 8
BLOCK_LANES = 1024  # lanes per block of the kernel's count and write passes
PROBE_MASK = 0x1B5
CLASSES = (1, 3, 9)


def _class_bits(mask: torch.Tensor, classes: int) -> torch.Tensor:
    """[nh / 128, classes, 128] bool: bit c of each lane's mask, per
    subgroup and class."""
    c = torch.arange(classes, dtype=torch.int32, device=mask.device)
    return ((mask.reshape(-1, 1, SUB) >> c[None, :, None]) & 1).bool()


def compact_index(mask: torch.Tensor, vals: torch.Tensor, classes: int) -> torch.Tensor:
    """The compacted entries [8, count] by one boolean index over the
    (subgroup, class, lane)-expanded view of vals."""
    ng = mask.numel() // SUB
    view = vals.reshape(VAL_ROWS, ng, 1, SUB).expand(VAL_ROWS, ng, classes, SUB)
    return view[:, _class_bits(mask, classes)]


def probe_compact_plain(mask: torch.Tensor, vals: torch.Tensor, classes: int):
    """Plain PyTorch version of probe_compact (same contract)."""
    nh = mask.numel()
    sel = compact_index(mask, vals, classes)
    stream = torch.empty((VAL_ROWS, nh * classes), dtype=torch.float32, device=vals.device)
    stream[:, : sel.shape[1]] = sel
    return stream, torch.tensor([sel.shape[1]], dtype=torch.int32, device=vals.device)


def probe_compact(mask: torch.Tensor, vals: torch.Tensor, classes: int):
    """Probe H: mask [1, nh] (or [nh]) int32, vals [8, nh] f32, nh a
    multiple of 128, 1 ≤ classes ≤ 32 → (stream [8, nh·classes] f32, count
    [1] int32 on vals' device). Entry k of the stream, for k < count, is
    the k-th (subgroup, class, lane) in that order whose mask bit `class`
    is set: the lane's column of vals. Columns at or past count are not
    written. The count stays on the device (no host sync).

    Kernel H, csrc/probe_compact.cu; replaces the TPU kernel
    tools/probe_compact.py::_kernel. CPU tensors take the plain version;
    CUDA tensors launch the kernel (there is no fallback)."""
    nh = mask.numel()
    if nh % SUB != 0 or not 1 <= classes <= 32:
        raise ValueError(f"probe_compact: nh ({nh}) must be a multiple of {SUB} and "
                         f"classes ({classes}) within 1..32")
    if vals.device.type == "cpu":
        return probe_compact_plain(mask, vals, classes)
    if (vals.device.type != "cuda" or mask.device != vals.device
            or mask.dtype != torch.int32 or vals.dtype != torch.float32
            or tuple(vals.shape) != (VAL_ROWS, nh)):
        raise ValueError("probe_compact: expected int32 mask [nh] and f32 vals "
                         f"[8, nh] on one cuda device, got {mask.dtype} "
                         f"{tuple(mask.shape)}, {vals.dtype} {tuple(vals.shape)}")
    mask, vals = mask.contiguous(), vals.contiguous()
    dev = vals.device
    nb = -(-nh // BLOCK_LANES)
    scratch = torch.empty((2, nb), dtype=torch.int32, device=dev)
    stream = torch.empty((VAL_ROWS, nh * classes), dtype=torch.float32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    err = kernels.lib("probes").gsjax_probe_compact(
        mask.data_ptr(), vals.data_ptr(), nh, classes, scratch[0].data_ptr(),
        scratch[1].data_ptr(), stream.data_ptr(), nh * classes, count.data_ptr(),
        kernels.stream_ptr(vals))
    kernels.check(err, "probe_compact")
    kernels.LAUNCHES["probe_compact"] += 1
    return stream, count


def probe_inputs(nh: int, device):
    """The probe's own inputs at nh (cut to a multiple of 2048): mask
    0x1B5 everywhere, vals = 1."""
    nh = nh // R * R
    mask = torch.full((1, nh), PROBE_MASK, dtype=torch.int32, device=device)
    return mask, torch.ones((VAL_ROWS, nh), dtype=torch.float32, device=device)


def main(argv=None) -> None:
    ap = device_parser(__doc__.splitlines()[0])
    ap.add_argument("--nh", type=int, default=2_400_000)
    args = ap.parse_args(argv)
    dev = open_device(args.device)
    mask, vals = probe_inputs(args.nh, dev)
    nh = mask.numel()
    for classes in CLASSES:
        t = time_ms(lambda: probe_compact(mask, vals, classes), dev, args.reps)
        count = int(probe_compact(mask, vals, classes)[1][0])
        slots = nh * classes
        print(f"classes={classes}: {t:8.4f} ms   {t * 1e6 / slots:6.3f} ns/slot "
              f"({t * 1e6 / (nh // SUB * classes):7.1f} ns per subgroup-class); "
              f"{count} entries")


if __name__ == "__main__":
    main()
