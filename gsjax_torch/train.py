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
over. Tile-sharded training waits for the multi-device port.
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


def make_step_fn(cam: Camera, cfg: RenderConfig, optimizer):
    """One training step at `cam`: step(g, target) → loss (a 0-d tensor
    on g's device), loss = mean((render − target)²). The optimizer must
    hold g's parameters; they are updated in place."""

    def step(g: Gaussians, target: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = torch.mean((render(g, cam, cfg) - target) ** 2)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def fit(g: Gaussians, cameras, targets, cfg: RenderConfig = RenderConfig(),
        steps: int = 100, optimizer=None, mesh=None, log_every: int = 0):
    """Fit `g` to the (cameras[i], targets[i]) pairs, cycling through the
    views; each step renders its own view's camera. Returns
    (TrainState, losses). `g` is trained in place."""
    if mesh is not None:
        raise NotImplementedError(
            "tile-sharded training is not ported yet: ROADMAP queue 1 "
            "'multi-device'"
        )
    optimizer = optimizer or default_optimizer(g)
    tgts = [torch.as_tensor(t, dtype=torch.float32, device=g.device) for t in targets]
    step_fns = [make_step_fn(cam, cfg, optimizer) for cam in cameras]
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
