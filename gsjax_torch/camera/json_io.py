"""COLMAP-style camera JSON import and export — the PyTorch counterpart
of gsjax/camera/json_io.py.

`camera_from_json` takes {position, rotation, fx, fy, width, height},
position as {x, y, z} or a flat [3] list and rotation as a {x, y, z, w}
quaternion or a 3×3 nested matrix (COLMAP's convention);
`camera_to_json` writes the same shape plus the id / img_name fields of
graphdeco's cameras.json. The cameras' tensors go to the card unless
device="cpu" is passed.
"""

from __future__ import annotations

import json

import numpy as np

from gsjax_torch.core.camera import Camera
from gsjax_torch.core.gaussians import rotmat_to_quat


def camera_from_json(data, near: float = 0.01, far: float = 1000.0,
                     device="cuda") -> Camera:
    """Build a Camera from a parsed JSON dict (or a JSON string)."""
    if isinstance(data, (str, bytes)):
        data = json.loads(data)
    pos = data["position"]
    if isinstance(pos, dict):
        position = np.array([pos["x"], pos["y"], pos["z"]], np.float32)
    else:
        position = np.asarray(pos, np.float32).reshape(3)
    rot = data["rotation"]
    if isinstance(rot, dict):  # a quaternion stored as {x, y, z, w}
        quat = np.array([rot["w"], rot["x"], rot["y"], rot["z"]], np.float32)
    else:
        quat = rotmat_to_quat(np.asarray(rot, np.float32).reshape(3, 3))
    return Camera.create(
        position=position,
        quat=quat,
        fx=float(data["fx"]),
        fy=float(data["fy"]),
        width=int(data.get("width", 800)),
        height=int(data.get("height", 600)),
        near=near,
        far=far,
        device=device,
    )


def cameras_from_json(data, device="cuda") -> list:
    """Parse a graphdeco cameras.json (a list of camera dicts)."""
    if isinstance(data, (str, bytes)):
        data = json.loads(data)
    return [camera_from_json(d, device=device) for d in data]


def camera_to_json(cam: Camera, id: int = 0, img_name: str = "NONE") -> dict:
    """The camera as a JSON-ready dict (the reference's dumpSettings)."""
    q = cam.quat.detach().cpu().numpy().astype(np.float32)
    p = cam.position.detach().cpu().numpy().astype(np.float32)
    return {
        "id": id,
        "img_name": img_name,
        "width": cam.width,
        "height": cam.height,
        "position": {"x": float(p[0]), "y": float(p[1]), "z": float(p[2])},
        "rotation": {"x": float(q[1]), "y": float(q[2]), "z": float(q[3]),
                     "w": float(q[0])},
        "fy": float(cam.fy),
        "fx": float(cam.fx),
    }
