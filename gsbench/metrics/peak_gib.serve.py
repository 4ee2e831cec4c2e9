"""The device's peak allocated memory over the serving window
(torch.cuda.max_memory_allocated after a reset at the window's start), in
GiB. Moves frames_per_s."""

from gsbench import harness

read = harness.peak_gib
