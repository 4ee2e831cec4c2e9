"""One rank of a two-process tile-sharded training run — the PyTorch
counterpart of tools/mp_worker.py.

    python -m gsjax_torch.parallel.mp_worker <rank> <world> <store> <out_dir> [--device D]

Joins a gloo process group through the `file://<store>` store (the file
must not exist before the first rank starts), builds a band mesh of two
bands a rank over it, takes 3 make_train_step steps (xla backend,
Adam(1e-2)) on the reference worker's 80-splat scene toward a flat 0.25
target and renders the result with render_sharded; rank 0 writes the
losses to <out_dir>/losses.txt and the frame to <out_dir>/frame.npy.
`--device` (default cuda; cpu on a host without a card) is where the
tensors live: gloo sums CUDA tensors too, so two ranks can share one
card (NCCL refuses that). `run(mesh)` is the same on any mesh: one process with four bands
gives the losses and the frame the two ranks must give.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from gsjax_torch.core.camera import Camera
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.core.gaussians import Gaussians
from gsjax_torch.parallel.mesh import init_multihost, make_mesh
from gsjax_torch.parallel.render_sharded import make_train_step, pad_target, render_sharded

BANDS_PER_RANK, STEPS = 2, 3


def run(mesh):
    """The worker's 3 steps on `mesh` (on its device), then
    render_sharded: (the losses, the frame [64, 64, 3] as numpy), every
    rank the same."""
    device = mesh.device
    cfg = RenderConfig(backend="xla", tile_list_cap=128, chunk=32)
    cam = Camera.create(fx=60, fy=60, width=64, height=64, device=device)
    rng = np.random.default_rng(7)
    n = 80
    g = Gaussians.from_activated(
        means=rng.normal(0, 1.0, (n, 3)).astype(np.float32) + np.array([0, 0, 5], np.float32),
        scales=np.full((n, 3), 0.08, np.float32),
        quats=np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        opacities=np.full((n,), 0.7, np.float32),
        rgb=rng.uniform(0.2, 0.9, (n, 3)).astype(np.float32),
        device=device,
    )
    target = pad_target(cfg, cam, np.zeros((64, 64, 3), np.float32) + 0.25, mesh.n_bands,
                        device=device)
    step = make_train_step(cam, cfg, mesh, torch.optim.Adam(g.parameters(), lr=1e-2))
    losses = [float(step(g, target)[0]) for _ in range(STEPS)]
    with torch.no_grad():
        frame = render_sharded(g, cam, cfg, mesh)[:64, :64]
    return losses, frame.cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("store")
    ap.add_argument("out_dir")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    group = init_multihost("gloo", f"file://{os.path.abspath(args.store)}", args.world,
                           args.rank)
    try:
        losses, frame = run(make_mesh(BANDS_PER_RANK * args.world, args.device, group))
    finally:
        torch.distributed.destroy_process_group()
    if args.rank == 0:
        with open(os.path.join(args.out_dir, "losses.txt"), "w") as fh:
            fh.write(" ".join(f"{v:.8f}" for v in losses))
        np.save(os.path.join(args.out_dir, "frame.npy"), frame)
    print(f"rank {args.rank}: losses={losses}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
