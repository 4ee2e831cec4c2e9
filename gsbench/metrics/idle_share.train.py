"""The device's idle share over the traced training window: 1 − the union
of its operations' intervals over the window's wall time, in %. Moves
train_step_ms."""

from gsbench import harness

read = harness.idle_share
