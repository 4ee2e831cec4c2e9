"""Scene edits — the PyTorch counterpart of examples/scene_transformations.py
(the reference's scene-transformations example: translate, rotate,
scale and limitBox, then save). Renders before and after; on the card
each render runs kernels A, B and C.

    python -m gsjax_torch.examples.scene_transformations [scene] [--device cpu] [--out DIR]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gsjax_torch.core import transforms
from gsjax_torch.core.camera import Camera
from gsjax_torch.examples._common import (AT, EYE, Overflow, load_or_demo, out_path,
                                          overflow_line, parser, sized_config)
from gsjax_torch.io.splat import save_splat
from gsjax_torch.render.pipeline import render
from gsjax_torch.utils.image import write_png


def transformed(g):
    """The reference example's edits: 30° about +y, then (0.3, 0, 0),
    then a scale of 0.8, then the splats outside the box x, y in [-2, 2],
    z in [1, 7] faded out."""
    half = np.deg2rad(30.0) / 2
    g2 = transforms.rotate(g, (np.cos(half), 0.0, np.sin(half), 0.0))
    g2 = transforms.translate(g2, (0.3, 0.0, 0.0))
    g2 = transforms.scale(g2, 0.8)
    return transforms.limit_box(g2, -2.0, 2.0, -2.0, 2.0, 1.0, 7.0)


def run(scene=None, *, device="cuda", out=None, n: int = 4000, width: int = 640,
        height: int = 480, fx: float = 500.0) -> dict:
    """Render the scene (the demo scene of n splats without one) to
    transform_before.png, edit it (transformed), render the result to
    transform_after.png and save it as transformed.splat. Returns before
    and after [H, W, 3] (numpy), paths, cfg, demand, overflow and
    renders."""
    g = load_or_demo(scene, device, n=n)
    cam = Camera.look_at(EYE, AT, fx=fx, fy=fx, width=width, height=height, device=device)
    with torch.no_grad():  # an edit: g2 holds parameters of its own
        g2 = transformed(g)
    cfg, demand = sized_config([g, g2], [cam], backend="auto")
    ovf = Overflow()
    frames = []
    with torch.no_grad():
        for scene_g in (g, g2):
            img, aux = render(scene_g, cam, cfg, return_aux=True)
            ovf(aux)
            frames.append(img.cpu().numpy())
    paths = [out_path(out, name) for name in
             ("transform_before.png", "transform_after.png", "transformed.splat")]
    write_png(paths[0], frames[0])
    write_png(paths[1], frames[1])
    save_splat(g2, paths[2])
    return dict(before=frames[0], after=frames[1], paths=paths, cfg=cfg, demand=demand,
                overflow=ovf.counts(), renders=ovf.n)


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    res = run(args.scene, device=args.device, out=args.out)
    print(f"wrote {', '.join(res['paths'])}; measured demand {res['demand']}")
    print(overflow_line(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
