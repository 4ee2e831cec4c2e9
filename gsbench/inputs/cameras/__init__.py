"""Camera sets as plain numbers: a frozen copy of bench.py's orbit
(`gsjax_torch/bench/run.py::orbit_cameras`, `camera/orbit.py`,
`Camera.look_at` and `rotmat_to_quat`), computed in numpy float64.

A camera is a dict {position [3] f32, quat [4] f32 (w, x, y, z, camera to
world), fx, fy, width, height}: the port takes it through
`Camera.create`, the reference builds its own matrices from it.

A configuration names its camera set's kind (`cameras.kind`): the module
gsbench/inputs/cameras/<kind>.py, whose cameras(spec) gives the list. A
new kind is a new file.
"""

from __future__ import annotations

import numpy as np

from gsbench import harness


def _rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """(w, x, y, z) of a proper rotation matrix (Shepperd's branches)."""
    m = R
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s]
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s,
             (m[0, 2] + m[2, 0]) / s]
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s,
             (m[1, 2] + m[2, 1]) / s]
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
             (m[1, 2] + m[2, 1]) / s, 0.25 * s]
    q = np.asarray(q)
    return (q / np.linalg.norm(q)).astype(np.float32)


def look_at(position, target, fx: float, fy: float, width: int, height: int,
            up=(0.0, 1.0, 0.0)) -> dict:
    """A camera at `position` looking at `target`, OpenCV axes (z forward,
    y down, x = y × z)."""
    position = np.asarray(position, np.float64)
    target = np.asarray(target, np.float64)
    fwd = target - position
    fwd = fwd / np.linalg.norm(fwd)
    x = np.cross(fwd, np.asarray(up, np.float64))
    x = x / np.linalg.norm(x)
    y = np.cross(fwd, x)
    rc2w = np.stack([x, y, fwd], axis=1)
    return {"position": position.astype(np.float32), "quat": _rotmat_to_quat(rc2w),
            "fx": float(fx), "fy": float(fy), "width": int(width), "height": int(height)}


def make(spec: dict) -> list:
    """The cameras of a configuration's `cameras` entry, by its kind."""
    return harness.module_at("inputs/cameras", spec["kind"]).cameras(spec)
