"""Training: fit Gaussians to target images — the PyTorch counterpart of
gsjax/train.py.

render → mean squared error → Adam on the raw parameters (the five
`nn.Parameter`s of a Gaussians module), one step per (camera, target)
pair. On the card the forward runs kernels A, B and the blend's forward,
the backward the blend's backward (gsjax_torch/csrc): kernels C and D
with RenderConfig(backend="stream") (the default), E and F with
backend="pallas" (the flat slot stream). `optax.adam` and `torch.optim.Adam` share the update
formula (bias-corrected moments, eps added to the root of the second),
so the reference's per-parameter learning-rate split is one torch Adam
with five parameter groups. A step updates the parameters in place (the
reference donates them to a jitted step and returns new ones).

Checkpoints are `torch.save` files of the module's and the optimizer's
state dicts plus the step; the reference's orbax format is not carried
over. With a band mesh (parallel/mesh.py), fit trains through the
tile-sharded step (parallel/render_sharded.make_train_step).
"""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch.core.camera import Camera
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.core.gaussians import Gaussians
from gsjax_torch.render.pipeline import render


@dataclasses.dataclass
class TrainState:
    gaussians: Gaussians
    optimizer: torch.optim.Optimizer
    step: int = 0


def default_optimizer(g: Gaussians, lr_means: float = 1.6e-4,
                      lr_scales: float = 5e-3, lr_quats: float = 1e-3,
                      lr_sh: float = 2.5e-3, lr_opacity: float = 5e-2):
    """Per-parameter Adam, 3DGS-style learning-rate split, optax's
    defaults (betas 0.9 / 0.999, eps 1e-8)."""
    groups = [
        {"params": [g.means], "lr": lr_means},
        {"params": [g.log_scales], "lr": lr_scales},
        {"params": [g.quats], "lr": lr_quats},
        {"params": [g.sh], "lr": lr_sh},
        {"params": [g.opacity_logits], "lr": lr_opacity},
    ]
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)


def make_step_fn(cam: Camera, cfg: RenderConfig, optimizer, on_aux=None):
    """One training step at `cam`: step(g, target) → loss (a 0-d tensor
    on g's device), loss = mean((render − target)²). The optimizer must
    hold g's parameters; they are updated in place. on_aux(aux), when
    given, is called with each step's render aux (its overflow
    counters)."""

    def step(g: Gaussians, target: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        img, aux = render(g, cam, cfg, return_aux=True)
        if on_aux is not None:
            on_aux(aux)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def fit(g: Gaussians, cameras, targets, cfg: RenderConfig = RenderConfig(),
        steps: int = 100, optimizer=None, mesh=None, log_every: int = 0,
        on_aux=None):
    """Fit `g` to the (cameras[i], targets[i]) pairs, cycling through the
    views; each step renders its own view's camera. With `mesh` (a band
    mesh, parallel/mesh.make_mesh) each step is the tile-sharded one, whose
    loss is the squared error over the tile-rounded image's pixels (the
    mean when the image is whole tiles). Returns (TrainState, losses).
    `g` is trained in place. on_aux(aux), when given, is called with each
    step's counters (a render's aux; a sharded step's, summed over its
    bands)."""
    optimizer = optimizer or default_optimizer(g)
    if mesh is None:
        tgts = [torch.as_tensor(t, dtype=torch.float32, device=g.device) for t in targets]
        step_fns = [make_step_fn(cam, cfg, optimizer, on_aux) for cam in cameras]
    else:
        from gsjax_torch.parallel.render_sharded import make_train_step, pad_target

        tgts = [pad_target(cfg, cam, t, mesh.n_bands, device=g.device)
                for cam, t in zip(cameras, targets)]
        sharded = [make_train_step(cam, cfg, mesh, optimizer) for cam in cameras]
        def sharded_step(g, t, f):
            loss, aux = f(g, t)
            if on_aux is not None:
                on_aux(aux)
            return loss

        step_fns = [lambda g, t, f=f: sharded_step(g, t, f) for f in sharded]
    losses = []
    for s in range(steps):
        i = s % len(cameras)
        losses.append(float(step_fns[i](g, tgts[i])))
        if log_every and s % log_every == 0:
            print(f"step {s}: loss {losses[-1]:.6f}")
    return TrainState(g, optimizer, steps), losses


# -- checkpointing ----------------------------------------------------------


def save_checkpoint(path, state: TrainState) -> None:
    """torch.save of the parameters, the optimizer state and the step."""
    torch.save(
        {
            "gaussians": state.gaussians.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step,
        },
        path,
    )


def load_checkpoint(path, reference: TrainState) -> TrainState:
    """Restore a checkpoint written by save_checkpoint into `reference`'s
    module and optimizer (which fix the shapes and the device)."""
    ckpt = torch.load(path, map_location=reference.gaussians.device,
                      weights_only=True)
    reference.gaussians.load_state_dict(ckpt["gaussians"])
    reference.optimizer.load_state_dict(ckpt["optimizer"])
    return TrainState(reference.gaussians, reference.optimizer, int(ckpt["step"]))
