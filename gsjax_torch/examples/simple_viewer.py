"""Orbit-view a scene and write frames — the PyTorch counterpart of
examples/simple_viewer.py, the headless form of the reference's
simple-server example (load a scene, orbit controls, a render a frame).
On the card each frame runs kernels A, B and C once.

    python -m gsjax_torch.examples.simple_viewer [scene] [--device cpu] [--out DIR]
"""

from __future__ import annotations

import sys

from gsjax_torch.camera.orbit import OrbitCamera
from gsjax_torch.examples._common import (Overflow, load_or_demo, out_path, overflow_line,
                                          parser, sized_config)
from gsjax_torch.viewer import render_orbit

ORBIT = dict(radius=5.0, target=(0.0, 0.0, 4.0), beta=0.3)


def run(scene=None, *, device="cuda", out=None, n: int = 4000, n_frames: int = 8,
        width: int = 640, height: int = 480, fx: float = 500.0) -> dict:
    """Render an n_frames orbit of the scene (the demo scene of n splats
    without one) and write frame_%04d.png under out/simple_viewer/.
    Returns frames [F, H, W, 3] (numpy), out_dir, cfg, demand, overflow
    and renders."""
    g = load_or_demo(scene, device, n=n)
    cam_kw = dict(width=width, height=height, fx=fx, fy=fx, device=device)
    cams = OrbitCamera(**ORBIT).trajectory(n_frames, **cam_kw)
    cfg, demand = sized_config(g, cams, backend="auto")
    ovf = Overflow()
    out_dir = out_path(out, "simple_viewer")
    frames = render_orbit(g, n_frames=n_frames, **ORBIT, cfg=cfg, out_dir=out_dir,
                          on_aux=ovf, **cam_kw)
    return dict(frames=frames, out_dir=out_dir, cfg=cfg, demand=demand,
                overflow=ovf.counts(), renders=ovf.n)


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    res = run(args.scene, device=args.device, out=args.out)
    print(f"wrote {len(res['frames'])} frames to {res['out_dir']}; measured demand "
          f"{res['demand']}")
    print(overflow_line(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
