"""Pinhole camera — the PyTorch counterpart of gsjax/core/camera.py.

  - world→camera: p_cam = R_w2c @ p_world + t_w2c, camera looks down +z;
  - pixel coords: x_px = fx · x/z + (W-1)/2 (pixel centers at integers).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gsjax_torch.core.gaussians import quat_to_rotmat, rotmat_to_quat


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pose is (position [3], quat [4] (w,x,y,z), camera-to-world); fx/fy
    are 0-d float32 tensors, the rest plain numbers. `create` and
    `look_at` put the tensors on the card unless device="cpu" is
    passed."""

    position: torch.Tensor
    quat: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    width: int = 800
    height: int = 600
    near: float = 0.01
    far: float = 1000.0

    @staticmethod
    def create(position=(0.0, 0.0, 0.0), quat=(1.0, 0.0, 0.0, 0.0),
               fx: float = 1132.0, fy: float = 1132.0, width: int = 800,
               height: int = 600, near: float = 0.01, far: float = 1000.0,
               device="cuda") -> "Camera":
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        return Camera(
            position=t(position),
            quat=t(quat),
            fx=t(fx),
            fy=t(fy),
            width=int(width),
            height=int(height),
            near=float(near),
            far=float(far),
        )

    from_numpy = create  # the bridge: numpy values in, same f32 bits

    @staticmethod
    def look_at(position, target, up=(0.0, 1.0, 0.0), **kwargs) -> "Camera":
        """Camera at `position` looking at `target` (+z toward target);
        `kwargs` go to `create` (intrinsics, image size, device)."""
        position = np.asarray(position, np.float64)
        target = np.asarray(target, np.float64)
        up = np.asarray(up, np.float64)
        fwd = target - position
        fwd = fwd / np.linalg.norm(fwd)
        # OpenCV axes: z forward, y down, x = y × z (det = +1)
        x = np.cross(fwd, up)
        nx = np.linalg.norm(x)
        if nx < 1e-8:
            alt = np.array([1.0, 0.0, 0.0]) if abs(fwd[0]) < 0.9 else np.array([0.0, 0.0, 1.0])
            x = np.cross(fwd, alt)
            nx = np.linalg.norm(x)
        x = x / nx
        y = np.cross(fwd, x)
        Rc2w = np.stack([x, y, fwd], axis=1)
        return Camera.create(position=position, quat=rotmat_to_quat(Rc2w), **kwargs)

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self,
            position=self.position.to(device),
            quat=self.quat.to(device),
            fx=self.fx.to(device),
            fy=self.fy.to(device),
        )

    # -- matrices -----------------------------------------------------------

    def rotation_c2w(self) -> torch.Tensor:
        q = self.quat / torch.clamp(torch.linalg.norm(self.quat), min=1e-12)
        return quat_to_rotmat(q)

    def view_matrix(self) -> torch.Tensor:
        """[4, 4] world→camera."""
        Rw2c = self.rotation_c2w().T
        t = -(Rw2c @ self.position)
        m = torch.eye(4, dtype=torch.float32, device=self.position.device)
        m[:3, :3] = Rw2c
        m[:3, 3] = t
        return m

    def tan_half_fov(self):
        return (
            self.width / (2.0 * self.fx),
            self.height / (2.0 * self.fy),
        )
