"""Load .splat / .ply / quantized .ply, render one frame, save to .splat —
the PyTorch counterpart of examples/file_loader.py (the reference's
file-loader example: the format picked by the file's extension, then the
scene saved back). On the card the frame runs kernels A, B and C.

    python -m gsjax_torch.examples.file_loader [scene] [--device cpu] [--out DIR]
"""

from __future__ import annotations

import os
import sys

import torch

from gsjax_torch.core.camera import Camera
from gsjax_torch.examples._common import (AT, EYE, Overflow, demo_scene, out_path,
                                          overflow_line, parser, sized_config)
from gsjax_torch.io.ply import load_ply
from gsjax_torch.io.splat import load_splat, save_splat
from gsjax_torch.render.pipeline import render
from gsjax_torch.utils.image import write_png

def load_any(path, device="cuda"):
    """The loader by extension, as the reference example picks it:
    .splat, .qply (the quantized codebook .ply), .ply (with its SH);
    anything else raises ValueError."""
    path = os.fspath(path)
    if path.endswith(".splat"):
        return load_splat(path, device=device)
    if path.endswith(".qply"):
        return load_ply(path, quantized=True, device=device)
    if path.endswith(".ply"):
        return load_ply(path, use_shs=True, device=device)
    raise ValueError(f"unsupported scene format: {path}")


def run(scene=None, *, device="cuda", out=None, n: int = 4000, width: int = 640,
        height: int = 480, fx: float = 500.0) -> dict:
    """Load `scene` (the demo scene of n splats without one), render one
    frame to file_loader.png and save the scene as scene_out.splat.
    Returns frame [H, W, 3] (numpy), n, sh (coefficients a channel),
    paths, cfg, demand, overflow and renders."""
    g = demo_scene(n=n, device=device) if scene is None else load_any(scene, device)
    cam = Camera.look_at(EYE, AT, fx=fx, fy=fx, width=width, height=height, device=device)
    cfg, demand = sized_config(g, [cam], backend="auto")
    ovf = Overflow()
    with torch.no_grad():
        img, aux = render(g, cam, cfg, return_aux=True)
    ovf(aux)
    frame = img.cpu().numpy()
    png, splat = out_path(out, "file_loader.png"), out_path(out, "scene_out.splat")
    write_png(png, frame)
    save_splat(g, splat)  # the reference's Scene.saveToFile
    return dict(frame=frame, n=g.n, sh=g.sh.shape[1], paths=[png, splat], cfg=cfg,
                demand=demand, overflow=ovf.counts(), renders=ovf.n)


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    res = run(args.scene, device=args.device, out=args.out)
    print(f"{args.scene or 'synthetic scene'}: {res['n']} splats, {res['sh']} SH coeffs; "
          f"wrote {' and '.join(res['paths'])}; measured demand {res['demand']}")
    print(overflow_line(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
