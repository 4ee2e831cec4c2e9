"""Tile-sharded rendering and one training step over an 8-band mesh —
the PyTorch counterpart of examples/sharded_render.py. The reference
simulates an 8-device host on the CPU; here the 8 bands run one after
another in one process (gsjax_torch.parallel.mesh.make_mesh(8)), each on
its own share of the tile rows: the exact xla path, so each band runs
kernels A and B (its layout and pairs) and the padded-list blend, forward
and backward.

    python -m gsjax_torch.examples.sharded_render [--device cpu] [--out DIR]
"""

from __future__ import annotations

import sys

import torch

from gsjax_torch.core.autotune import derive_shard_caps
from gsjax_torch.core.camera import Camera
from gsjax_torch.examples._common import (AT, EYE, Overflow, demo_scene, out_path,
                                          overflow_line, parser, sized_config)
from gsjax_torch.parallel.mesh import band_rows_for, make_mesh
from gsjax_torch.parallel.render_sharded import make_train_step, pad_target, render_sharded
from gsjax_torch.utils.image import write_png


def run(*, device="cuda", out=None, n: int = 2000, n_bands: int = 8, width: int = 512,
        height: int = 384, fx: float = 400.0, tile_list_cap: int = 256,
        lr: float = 1e-3) -> dict:
    """Render the demo scene (n splats) over n_bands bands to sharded.png,
    then take one sharded Adam(lr) step toward a black target. The budgets:
    sized_config's, then derive_shard_caps' for the bands. Returns frame
    [H, W, 3] (numpy, cropped from the padded bands), loss, paths, cfg,
    demand, overflow and renders (the step's bands count as one)."""
    mesh = make_mesh(n_bands, device)
    g = demo_scene(n=n, device=device)
    cam = Camera.look_at(EYE, AT, fx=fx, fy=fx, width=width, height=height, device=device)
    cfg, demand = sized_config(g, [cam], backend="xla", tile_list_cap=tile_list_cap)
    cfg = derive_shard_caps(g, cam, cfg, band_rows=band_rows_for(cfg, height, n_bands))
    ovf = Overflow()
    with torch.no_grad():
        img, aux = render_sharded(g, cam, cfg, mesh, return_aux=True)
    ovf(aux)
    frame = img[:height, :width].cpu().numpy()
    path = out_path(out, "sharded.png")
    write_png(path, frame)
    step = make_train_step(cam, cfg, mesh, torch.optim.Adam(g.parameters(), lr=lr))
    target = pad_target(cfg, cam, torch.zeros((height, width, 3), device=device), n_bands)
    loss, aux = step(g, target)
    ovf(aux)
    return dict(frame=frame, loss=float(loss), paths=[path], cfg=cfg, demand=demand,
                overflow=ovf.counts(), renders=ovf.n)


def main(argv=None) -> int:
    args = parser(__doc__, scene=False).parse_args(argv)
    res = run(device=args.device, out=args.out)
    print(f"sharded render over 8 bands: {res['frame'].shape}, wrote {res['paths'][0]}; "
          f"one sharded train step: loss={res['loss']:.5f}; measured demand {res['demand']}")
    print(overflow_line(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
