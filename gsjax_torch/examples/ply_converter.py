""".ply → .splat conversion — the PyTorch counterpart of
examples/ply_converter.py (the reference's ply-converter example). With
no input it writes the demo scene of 500 splats as demo.ply and converts
that. Runs no kernel: the parse is on the host, the tensors on the
device.

    python -m gsjax_torch.examples.ply_converter [scene.ply] [--device cpu] [--out DIR]
"""

from __future__ import annotations

import sys

from gsjax_torch.examples._common import (OVERFLOW_KEYS, demo_scene, out_path, overflow_line,
                                          parser)
from gsjax_torch.io.ply import load_ply, save_ply
from gsjax_torch.io.splat import save_splat


def run(src=None, *, device="cuda", out=None, n: int = 500) -> dict:
    """Convert the .ply at `src` (without one: the demo scene of n splats,
    written as demo.ply first) to converted.splat. Returns src, out (the
    .splat's path), n, overflow (nothing rendered: all 0) and renders."""
    if src is None:
        g = demo_scene(n=n, device=device)
        src = out_path(out, "demo.ply")
        save_ply(g, src)
    dst = out_path(out, "converted.splat")
    g = load_ply(src, device=device)
    save_splat(g, dst)
    return dict(src=src, out=dst, n=g.n, overflow=dict.fromkeys(OVERFLOW_KEYS, 0), renders=0)


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    res = run(args.scene, device=args.device, out=args.out)
    print(f"{res['src']} → {res['out']} ({res['n']} splats)")
    print(overflow_line(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
