"""The device's idle share over the traced serving window: 1 − the union
of its operations' intervals over the window's wall time, in %. Moves
frames_per_s."""

from gsbench import harness

read = harness.idle_share
