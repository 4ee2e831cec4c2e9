"""Camera pose updates between frames and the camera JSON round trip —
the PyTorch counterpart of examples/camera_updates.py (the reference's
camera-updates example and Camera.setFromData / dumpSettings). On the
card each frame runs kernels A, B and C.

    python -m gsjax_torch.examples.camera_updates [scene] [--device cpu] [--out DIR]
"""

from __future__ import annotations

import json
import sys

import torch

from gsjax_torch.camera.json_io import camera_from_json, camera_to_json
from gsjax_torch.core.camera import Camera
from gsjax_torch.examples._common import (AT, EYE, Overflow, load_or_demo, out_path,
                                          overflow_line, parser, sized_config)
from gsjax_torch.render.pipeline import render
from gsjax_torch.utils.image import write_png

#: where the edited JSON moves the camera
POSITION_1 = [1.5, -0.5, -0.5]


def run(scene=None, *, device="cuda", out=None, n: int = 4000, width: int = 640,
        height: int = 480, fx: float = 500.0) -> dict:
    """Render pose 0 to camera_pose0.png, dump the camera to JSON, move
    it to POSITION_1 there, load it back and render pose 1 to
    camera_pose1.png; write both poses' JSON to camera.json. Returns
    frames [2, H, W, 3] (a list of numpy arrays), cameras (the JSON
    dicts), paths, cfg, demand, overflow and renders."""
    g = load_or_demo(scene, device, n=n)
    cam = Camera.look_at(EYE, AT, fx=fx, fy=fx, width=width, height=height, device=device)
    data = camera_to_json(cam)
    print("camera JSON:", json.dumps(data)[:120], "…")
    data["position"] = POSITION_1
    cam2 = camera_from_json(data, device=device)
    cfg, demand = sized_config(g, [cam, cam2], backend="auto")
    ovf = Overflow()
    frames = []
    with torch.no_grad():
        for c in (cam, cam2):
            img, aux = render(g, c, cfg, return_aux=True)
            ovf(aux)
            frames.append(img.cpu().numpy())
    paths = [out_path(out, name) for name in
             ("camera_pose0.png", "camera_pose1.png", "camera.json")]
    write_png(paths[0], frames[0])
    write_png(paths[1], frames[1])
    cameras = [camera_to_json(cam), camera_to_json(cam2)]
    with open(paths[2], "w") as fh:
        json.dump(cameras, fh, indent=2)
    return dict(frames=frames, cameras=cameras, paths=paths, cfg=cfg, demand=demand,
                overflow=ovf.counts(), renders=ovf.n)


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    res = run(args.scene, device=args.device, out=args.out)
    print(f"wrote two poses and {res['paths'][2]}; measured demand {res['demand']}")
    print(overflow_line(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
