"""Differentiable fitting: perturb a scene, then recover it by gradient
descent on rendered targets — the PyTorch counterpart of
examples/train_fit.py. On the card each target and evaluation render
runs kernels A, B and C, each training step A, B, C, D and D's class
sum.

The perturbation draws its noise from numpy.random.default_rng(1) where
the reference example draws jax.random.normal(PRNGKey(1)): the port
cannot draw JAX's stream, so the two examples fit different (equally
sized) perturbations. Each step renders its own view's camera; the
reference's fit keys its jitted step by image size, so all four of its
views (one size) train against the first camera.

    python -m gsjax_torch.examples.train_fit [--device cpu] [--out DIR]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gsjax_torch.camera.orbit import OrbitCamera
from gsjax_torch.core.gaussians import Gaussians
from gsjax_torch.examples._common import (Overflow, demo_scene, out_path, overflow_line,
                                          parser, sized_config)
from gsjax_torch.render.pipeline import render
from gsjax_torch.train import fit
from gsjax_torch.utils.image import write_png

ORBIT = dict(radius=5.0, target=(0, 0, 4.0), beta=0.2)


def perturbed(g, seed: int = 1) -> Gaussians:
    """g with 0.03·N(0, 1) (numpy's default_rng(seed), float32) added to
    the means and the SH halved: a scene of parameters of its own."""
    noise = np.random.default_rng(seed).normal(size=tuple(g.means.shape)).astype(np.float32)
    with torch.no_grad():
        return Gaussians(g.means + 0.03 * torch.from_numpy(noise).to(g.device), g.log_scales,
                         g.quats, g.sh * 0.5, g.opacity_logits)


def run(*, device="cuda", out=None, n: int = 400, n_views: int = 4, width: int = 128,
        height: int = 96, fx: float = 120.0, steps: int = 150, lr: float = 2e-4,
        log_every: int = 50) -> dict:
    """Render n_views orbit targets of the demo scene (n splats, SH degree
    0), perturb it and fit it back with Adam(lr) for `steps` steps,
    cycling the views; view 0's loss before and after (the steps cycle
    the views, so only the same view's losses compare) must fall. Writes
    fit_target.png and fit_result.png. Returns loss0, loss1, losses,
    target and result [H, W, 3] (numpy), paths, cfg, demand, overflow and
    renders."""
    g_true = demo_scene(n=n, sh_degree=0, device=device)
    cams = OrbitCamera(**ORBIT).trajectory(n_views, width=width, height=height, fx=fx, fy=fx,
                                           device=device)
    g = perturbed(g_true)
    cfg, demand = sized_config([g_true, g], cams, backend="auto")
    ovf = Overflow()

    def view0(scene):
        img, aux = render(scene, cams[0], cfg, return_aux=True)
        ovf(aux)
        return img, float(torch.mean((img - targets[0]) ** 2))

    with torch.no_grad():
        targets = []
        for c in cams:
            img, aux = render(g_true, c, cfg, return_aux=True)
            ovf(aux)
            targets.append(img)
        _, loss0 = view0(g)
    # a tiny deterministic full-batch problem: Adam's usual 3DGS rates
    # (train.default_optimizer) overshoot here; a small uniform rate
    # descends cleanly
    _, losses = fit(g, cams, targets, cfg, steps=steps,
                    optimizer=torch.optim.Adam(g.parameters(), lr=lr), log_every=log_every,
                    on_aux=ovf)
    with torch.no_grad():
        result, loss1 = view0(g)
    print(f"view-0 loss {loss0:.3e} → {loss1:.3e} after {len(losses)} steps")
    assert loss1 < loss0, (loss0, loss1)
    target, result = targets[0].cpu().numpy(), result.cpu().numpy()
    paths = [out_path(out, "fit_target.png"), out_path(out, "fit_result.png")]
    write_png(paths[0], target)
    write_png(paths[1], result)
    return dict(loss0=loss0, loss1=loss1, losses=losses, target=target, result=result,
                paths=paths, cfg=cfg, demand=demand, overflow=ovf.counts(), renders=ovf.n)


def main(argv=None) -> int:
    args = parser(__doc__, scene=False).parse_args(argv)
    res = run(device=args.device, out=args.out)
    print(f"wrote {' and '.join(res['paths'])}; measured demand {res['demand']}")
    print(overflow_line(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
