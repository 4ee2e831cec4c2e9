"""The orbit camera set: bench.py's (`gsjax_torch/bench/run.py::orbit_cameras`)."""

from __future__ import annotations

import numpy as np

from gsbench.inputs.cameras import look_at


def cameras(spec: dict) -> list:
    """bench.py's orbit: `views` cameras over `sweep_deg` of azimuth at
    radius hypot(4, 0.6) and the elevation of (0, -0.6, -4) about the
    origin, view 0 at that pose. spec: {"views", "sweep_deg", "fx", "fy",
    "width", "height"}."""
    r = float(np.hypot(4.0, 0.6))
    beta = float(np.arcsin(-0.6 / r))
    views = int(spec["views"])
    sweep = float(np.deg2rad(spec["sweep_deg"]))
    cams = []
    for i in range(views):
        alpha = float(np.pi) + sweep * i / views
        ca, sa = np.cos(alpha), np.sin(alpha)
        cb, sb = np.cos(beta), np.sin(beta)
        pos = r * np.array([sa * cb, sb, ca * cb])
        cams.append(look_at(pos, (0.0, 0.0, 0.0), spec["fx"], spec["fy"],
                            spec["width"], spec["height"]))
    return cams
