"""The device's peak allocated memory over the training window
(torch.cuda.max_memory_allocated after a reset at the window's start), in
GiB. Moves train_step_ms."""

from gsbench import harness

read = harness.peak_gib
