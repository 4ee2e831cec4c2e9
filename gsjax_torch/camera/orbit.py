"""Headless orbit-camera trajectories — the PyTorch counterpart of
gsjax/camera/orbit.py: the (alpha, beta, radius, target) orbit
parameterization and the pose it derives, as a reproducible trajectory
generator."""

from __future__ import annotations

import dataclasses

import numpy as np

from gsjax_torch.core.camera import Camera


@dataclasses.dataclass
class OrbitCamera:
    """Orbit state: azimuth alpha, elevation beta (radians), radius,
    target point."""

    alpha: float = 0.0
    beta: float = 0.0
    radius: float = 5.0
    target: tuple = (0.0, 0.0, 0.0)

    def camera(self, **cam_kwargs) -> Camera:
        """Pose for the current orbit state."""
        t = np.asarray(self.target, np.float64)
        ca, sa = np.cos(self.alpha), np.sin(self.alpha)
        cb, sb = np.cos(self.beta), np.sin(self.beta)
        pos = t + self.radius * np.array([sa * cb, sb, ca * cb])
        return Camera.look_at(pos, t, **cam_kwargs)

    def trajectory(self, n_frames: int, alpha_end: float = 2 * np.pi, **cam_kwargs):
        """n_frames cameras sweeping alpha from the current value."""
        return [
            dataclasses.replace(
                self, alpha=self.alpha + alpha_end * i / n_frames
            ).camera(**cam_kwargs)
            for i in range(n_frames)
        ]
