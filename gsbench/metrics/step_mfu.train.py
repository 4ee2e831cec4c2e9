"""The whole training step's share of the card's float32 peak, in %: the
operations the step needs over (the traced window's mean step time × 67
TFLOP/s). Moves train_step_ms.

The operations, counted once each (recomputation is not counted), from
the reference's work of the step's view and the scene's sizes:
  * projection and SH colour per splat, forward (gsbench/roofline.py),
    backward twice that;
  * the blend forward 39 per eligible live pair-pixel + 6 per included
    one, backward 39 + 46 (the kernels' rooflines' counts);
  * the loss, 9 per pixel forward and 9 backward;
  * Adam, 12 per parameter."""

from gsbench import roofline

LOSS_PIXEL = 18
ADAM_PARAM = 12


def read(art):
    w = art["work"]
    blend = ((roofline.FWD_OPS_LIVE + roofline.BWD_OPS_LIVE) * w["pp_live"]
             + (roofline.FWD_OPS_INCLUDED + roofline.BWD_OPS_INCLUDED) * w["pp_included"])
    ops = (3 * roofline.projection_ops(w) + blend + LOSS_PIXEL * w["pixels"]
           + ADAM_PARAM * w["n_params"])
    return roofline.mfu(art, ops)
