"""Kernel C's share of its roofline in the serving cell, in %: the least
time the forward blend's work takes on the card over C's device time,
both per frame of the traced window (gsbench/roofline.py counts the work).
Moves frames_per_s."""

from gsbench import roofline

read = roofline.blend_fwd_share
