"""The harness's side of the port: the program under test built from the
harness's inputs, through gsjax_torch's public entry points only
(Gaussians, Camera.create, RenderConfig, core.autotune, render,
LazyTrainer, train.make_step_fn / default_optimizer). Imported only
after the harness has found a card, so a directory without the port
fails there."""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch import kernels
from gsjax_torch.core.autotune import derive_caps, measure_occupancy
from gsjax_torch.core.camera import Camera
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.core.gaussians import Gaussians

from gsbench.inputs.scenes import FIELDS

#: the render and resort counters that count dropped work
OVERFLOW_KEYS = ("n_pair_overflow", "n_band_overflow", "n_tile_overflow",
                 "n_fat_overflow", "n_clamped")


def load_kernels(device) -> None:
    """Build (first run in a checkout) or load the port's kernel library."""
    if device.type == "cuda":
        kernels.lib()


def gaussians(params: dict) -> Gaussians:
    """The port's scene module holding clones of the harness's tensors."""
    return Gaussians(*(params[f].detach().clone() for f in FIELDS))


def camera(cam: dict, device) -> Camera:
    return Camera.create(position=cam["position"], quat=cam["quat"], fx=cam["fx"],
                         fy=cam["fy"], width=cam["width"], height=cam["height"],
                         device=device)


def render_config(spec: dict) -> RenderConfig:
    return RenderConfig(**spec)


def autotune(g: Gaussians, cams, cfg: RenderConfig) -> RenderConfig:
    """derive_caps over every view, measured at cfg's fat caps; where those
    overflow, measured again at the copy demand (bench/run.py's rule)."""
    ms = [measure_occupancy(g, c, cfg) for c in cams]
    if any(m["n_fat_overflow"] for m in ms):
        demand = -(-max(m["n_copies"] for m in ms) // 8192) * 8192
        cfg = dataclasses.replace(cfg, fat_cap=demand, fat_live_cap=demand)
        ms = [measure_occupancy(g, c, cfg) for c in cams]
    return derive_caps(g, cams, cfg, ms=ms)


def overflow_sum(aux: dict) -> torch.Tensor:
    """The counters of dropped work of one render or resort, summed on
    the device (no host read)."""
    return sum(aux[k].to(torch.int64) for k in OVERFLOW_KEYS if k in aux)


def leaf_norms(tensors: dict) -> dict:
    """{field: float L2 norm} of per-splat tensors."""
    return {f: float(torch.linalg.vector_norm(tensors[f].float())) for f in FIELDS}


def snapshot(g: Gaussians) -> dict:
    return {f: getattr(g, f).detach().clone() for f in FIELDS}


def change_norms(g: Gaussians, p0: dict) -> dict:
    return leaf_norms({f: getattr(g, f).detach() - p0[f] for f in FIELDS})
