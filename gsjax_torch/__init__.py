"""gsjax_torch — the PyTorch / CUDA port of gsjax for NVIDIA Hopper.

The serving path of gsjax: project + SH → home layout with fat-splat
splitting (CUDA kernel A) → pair expansion with the exact ellipse cull
(CUDA kernel B) and one stable (tile, depth, pid) sort → front-to-back
stream blend (CUDA kernel C), and its backward (CUDA kernel D) for
training (gsjax_torch.train: Adam steps, fit, checkpoints; lazy frame
plans, render/lazy.py: LazyTrainer reuses a resort's layout over steps,
with parameters and Adam state in home order, kernels C and D a step). With
RenderConfig(backend="pallas") the blend is gsjax's flat slot-stream
one instead (CUDA kernels E forward, F backward). On a CUDA
device the kernels run (built from gsjax_torch/csrc at first use); on the
CPU their plain PyTorch versions do. Constructors put tensors on the card
unless device="cpu" is passed. Never imports jax or gsjax.

  Gaussians, Camera, RenderConfig, render, OrbitCamera,
  render_trajectory, render_orbit, train, FramePlan, LazyTrainer,
  build_frame_plan, lazy_render
"""

from gsjax_torch.camera.orbit import OrbitCamera
from gsjax_torch.core.camera import Camera
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.core.gaussians import Gaussians
from gsjax_torch.render.lazy import FramePlan, LazyTrainer, build_frame_plan, lazy_render
from gsjax_torch.render.pipeline import render
from gsjax_torch.viewer import render_orbit, render_trajectory
from gsjax_torch import train

__all__ = [
    "Gaussians",
    "Camera",
    "RenderConfig",
    "render",
    "OrbitCamera",
    "render_trajectory",
    "render_orbit",
    "train",
    "FramePlan",
    "LazyTrainer",
    "build_frame_plan",
    "lazy_render",
]
