"""The whole frame's share of the card's float32 peak, in %: the
operations a frame needs over (the traced window's mean frame time × 67
TFLOP/s). Moves frames_per_s.

The operations, counted once each, as step_mfu.train counts them for the
forward alone: projection and SH colour per splat, and the blend's
forward per eligible live and included pair-pixel (gsbench/roofline.py)."""

from gsbench import roofline


def read(art):
    w = art["work"]
    return roofline.mfu(art, roofline.projection_ops(w)
                        + roofline.FWD_OPS_LIVE * w["pp_live"]
                        + roofline.FWD_OPS_INCLUDED * w["pp_included"])
