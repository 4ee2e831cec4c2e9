"""Kernels D and D′'s share of their roofline in the training cells, in %:
the least time the backward blend's work takes on the card over the two
kernels' device time (blend_bwd_kernel, class_sum_kernel), both per step
of the traced window.

The work is the reference's count of the step's view (at the training's
starting parameters, averaged over the window's steps): per eligible
pair-pixel before the pixel stopped and per included one the counts of
gsbench/roofline.py (BWD_OPS_*), per used row OPS_ROW (the class sum).
Bytes: each used attribute row read once and its gradient written once, each pair's id once, each pixel's forward output and
cotangent read once. Moves train_step_ms."""

from gsbench import harness, roofline

KERNELS = ("blend_bwd_kernel", "class_sum_kernel")
OPS_ROW = 9


def read(art):
    w, units = art["work"], art["units"]
    taken = harness.kernel_seconds(art, KERNELS) / units if units else 0.0
    n_bytes = 2 * w["rows"] * roofline.ATT_BYTES + w["pairs"] * 4 + w["pixels"] * 32
    n_ops = (roofline.BWD_OPS_LIVE * w["pp_live"] + roofline.BWD_OPS_INCLUDED * w["pp_included"]
             + OPS_ROW * w["rows"])
    return roofline.share(roofline.least_seconds(n_bytes, n_ops), taken)
