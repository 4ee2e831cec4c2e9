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

Scene IO and edits, as gsjax exports them: load_splat / save_splat
(.splat), load_ply (plain 3DGS .ply through the native C++ parser,
native/loader.cpp built at first use, or numpy; quantized=True the
codebook layout; banded=True a BandedGaussians, whose groups keep their
own SH degree and render through the same path), the streamed loaders
load_ply_streamed / load_splat_streamed (progress callbacks, paths or
byte streams), and `transforms` (translate, rotate, scale, limit_box,
crop_box). Loaders parse on the host and put the scene's tensors on the
card unless device="cpu" is passed. core/autotune.derive_caps sizes the
fat-split and pair budgets from a measured pass (project, kernels A and
B).

The reference paths, as gsjax's: RenderConfig(backend="oracle") (and
render_oracle), the O(N·pixels) ground truth, and backend="xla", the
padded-list blend, both plain PyTorch differentiated by autograd (xla's
exact mode bins through kernels A and B); footprint_clamp=True, the
legacy span budget, on every backend; render(..., passes=[...]) with
render/passes.py's depth_fade and splat_scale. The viewer loop: `controls`
(the reference's orbit controls as a pure state machine: apply_event,
update, to_camera), render_trajectory(fade_in=True), and camera JSON
(camera_from_json, cameras_from_json, camera_to_json).

The tile-sharded mesh, as gsjax keeps it out of its top level: import
gsjax_torch.parallel.mesh (make_mesh: tile-row bands over one process or
a torch.distributed group; init_multihost) and
gsjax_torch.parallel.render_sharded (render_sharded, make_train_step and
its equalized and balanced forms: each band through kernels A-D, the
gradients all-reduced); core/autotune.derive_row_cuts / derive_shard_caps
size the bands; train.fit(mesh=...) trains through it.

  Gaussians, BandedGaussians, Camera, RenderConfig, render, render_oracle,
  OrbitCamera, controls, camera_from_json, camera_to_json,
  cameras_from_json, render_trajectory, render_orbit, train, FramePlan,
  LazyTrainer, build_frame_plan, lazy_render, load_splat, save_splat,
  load_ply, load_ply_streamed, load_splat_streamed, transforms
"""

from gsjax_torch.camera import controls
from gsjax_torch.camera.json_io import camera_from_json, camera_to_json, cameras_from_json
from gsjax_torch.camera.orbit import OrbitCamera
from gsjax_torch.core import transforms
from gsjax_torch.core.banded import BandedGaussians
from gsjax_torch.core.camera import Camera
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.core.gaussians import Gaussians
from gsjax_torch.io.ply import load_ply
from gsjax_torch.io.splat import load_splat, save_splat
from gsjax_torch.io.stream import load_ply_streamed, load_splat_streamed
from gsjax_torch.render.lazy import FramePlan, LazyTrainer, build_frame_plan, lazy_render
from gsjax_torch.render.oracle import render_oracle
from gsjax_torch.render.pipeline import render
from gsjax_torch.viewer import render_orbit, render_trajectory
from gsjax_torch import train

__all__ = [
    "Gaussians",
    "Camera",
    "RenderConfig",
    "render",
    "render_oracle",
    "OrbitCamera",
    "controls",
    "camera_from_json",
    "camera_to_json",
    "cameras_from_json",
    "render_trajectory",
    "render_orbit",
    "train",
    "FramePlan",
    "LazyTrainer",
    "build_frame_plan",
    "lazy_render",
    "BandedGaussians",
    "load_splat",
    "save_splat",
    "load_ply",
    "load_ply_streamed",
    "load_splat_streamed",
    "transforms",
]
