"""Kernel C's share of its roofline in the training cells, in %: the least
time the forward blend's work takes on the card over C's device time,
both per step of the traced window (gsbench/roofline.py counts the work).
Moves train_step_ms."""

from gsbench import roofline

read = roofline.blend_fwd_share
