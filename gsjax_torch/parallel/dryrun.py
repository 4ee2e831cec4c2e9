"""One equalized tile-sharded training step on a tiny scene, checked —
the PyTorch counterpart of __graft_entry__.py's dryrun_multichip.

    python -m gsjax_torch.parallel.dryrun [N_DEVICES] [--device cuda|cpu]

The stream path at the reference's production settings (tile span 3,
exact footprints, fat splats split), a 2,048-splat bonsai_like scene
pushed toward the image's top rows (so the bands' content is uneven),
a 4·16 × N_DEVICES·2·16 camera, equal-content row cuts
(autotune.derive_row_cuts), one make_train_step_equalized step with
Adam(1e-3) over an N_DEVICES-band mesh in one process. Its gradients
must equal those of the whole-image render's loss within 1e-4 of each
leaf's peak, and every overflow counter must be 0. Prints the
reference's line: loss, cuts, grads_match and the summed counters.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from gsjax_torch.bench.synth import bonsai_like
from gsjax_torch.core.autotune import derive_row_cuts
from gsjax_torch.core.camera import Camera
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.core.gaussians import FIELDS, Gaussians
from gsjax_torch.parallel.mesh import make_mesh
from gsjax_torch.parallel.render_sharded import (_image_px, make_train_step_equalized,
                                                 pad_target_rows)
from gsjax_torch.render.pipeline import render

GRAD_TOL = 1e-4  # |Δ| over each leaf's peak
OVERFLOW = ("n_pair_overflow", "n_band_overflow", "n_tile_overflow", "n_fat_overflow")


def _scene(device) -> Gaussians:
    """bonsai_like(2048, SH degree 1) with every mean's y set to −0.8·|y|:
    most splats land in the top bands."""
    g = bonsai_like(n=2048, sh_degree=1, device="cpu")
    raw = {f: getattr(g, f).detach().numpy().copy() for f in FIELDS}
    raw["means"][:, 1] = -np.abs(raw["means"][:, 1]) * 0.8
    return Gaussians.from_numpy(*(raw[f] for f in FIELDS), device=device)


def dryrun_multichip(n_devices: int = 8, device="cuda") -> dict:
    """Run and check the step; raise if a check fails. Returns loss,
    cuts, aux (the counters as ints), grad_err (each leaf's max |Δ| over
    its peak) and the whole image's loss."""
    # the reference's configuration (its TPU band knobs are no-ops here)
    cfg = RenderConfig(backend="stream", chunk=32, stream_band_cap=4096, stream_block_tiles=3,
                       stream_dma_chunk=256, fat_max_blocks=64, fat_cap=512)
    ts = cfg.tile_size
    cam = Camera.create(fx=60.0, fy=60.0, width=4 * ts, height=n_devices * 2 * ts,
                        position=(0, 0, -3), device=device)
    g = _scene(device)
    params = [getattr(g, f) for f in FIELDS]
    opt = torch.optim.Adam(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    cuts = derive_row_cuts(g, cam, cfg, n_devices)
    band_max = max(cuts[i + 1] - cuts[i] for i in range(n_devices))
    step = make_train_step_equalized(cam, cfg, make_mesh(n_devices, device), opt, cuts)
    target = pad_target_rows(cfg, cam, torch.zeros((cam.height, cam.width, 3)), band_max,
                             device=device)

    # the whole image's loss at the same parameters: each pixel row is one
    # band's, so its gradient is the sharded one
    loss_single = torch.sum((render(g, cam, cfg) - target[:cam.height, :cam.width]) ** 2) / (
        _image_px(cam, cfg) * 3)
    grads_single = torch.autograd.grad(loss_single, params)
    loss, aux = step(g, target)
    grad_err = {}
    for f, a, p in zip(FIELDS, grads_single, params):
        a, b = a.double(), p.grad.double()
        grad_err[f] = float((a - b).abs().max() / (a.abs().max() + 1e-12))
        if not grad_err[f] < GRAD_TOL:
            raise RuntimeError(f"dryrun_multichip: sharded gradient of {f} differs from the "
                               f"whole image's by {grad_err[f]:.3e} of its peak")
    aux = {k: int(v) for k, v in sorted(aux.items())}
    for k in OVERFLOW:
        if aux[k]:
            raise RuntimeError(f"dryrun_multichip: {k} = {aux[k]}")
    print(f"dryrun_multichip({n_devices}): loss={float(loss):.6f} backend=stream "
          f"step=equalized cuts={cuts} grads_match=ok aux={aux}")
    return dict(loss=float(loss), cuts=cuts, aux=aux, grad_err=grad_err,
                loss_single=float(loss_single.detach()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
