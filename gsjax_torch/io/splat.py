""".splat file IO — the PyTorch counterpart of gsjax/io/splat.py.

32 bytes per splat:
  3 × f32  position
  3 × f32  linear scale
  4 × u8   RGBA color, opacity already sigmoided in A
  4 × u8   quaternion (w, x, y, z), component c stored as round(c·128)+128

Colors carry no view dependence, so they load as degree-0 SH:
rgb = 0.5 + SH_C0·sh0. Parsing is numpy on the host; the scene's tensors
are made once, on `device` (the card by default).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gsjax_torch.core.gaussians import SH_C0, Gaussians

ROW_LENGTH = 32


def parse_splat_bytes(buf: bytes) -> dict:
    """Parse raw .splat bytes into numpy SoA arrays (host side)."""
    if len(buf) % ROW_LENGTH != 0:
        raise ValueError(
            f".splat byte length {len(buf)} is not a multiple of {ROW_LENGTH}"
        )
    n = len(buf) // ROW_LENGTH
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(n, ROW_LENGTH)
    f32 = raw[:, :24].copy().view(np.float32).reshape(n, 6)
    rgba = raw[:, 24:28].astype(np.float32) / 255.0
    quats = (raw[:, 28:32].astype(np.float32) - 128.0) / 128.0  # (w, x, y, z)
    norm = np.maximum(np.linalg.norm(quats, axis=-1, keepdims=True), 1e-12)
    return {
        "positions": f32[:, 0:3],
        "scales": f32[:, 3:6],
        "rgb": rgba[:, :3],
        "opacities": rgba[:, 3],
        "quats": quats / norm,
    }


def from_splat_arrays(d: dict, device="cuda") -> Gaussians:
    """parse_splat_bytes' arrays → Gaussians on `device`."""
    return Gaussians.from_activated(means=d["positions"], scales=d["scales"],
                                    quats=d["quats"], opacities=d["opacities"],
                                    rgb=d["rgb"], device=device)


def load_splat(path_or_bytes, device="cuda") -> Gaussians:
    """Load a .splat file (a path, or its bytes) into Gaussians on
    `device`: the card unless device="cpu" is passed."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(os.fspath(path_or_bytes), "rb") as fh:
            buf = fh.read()
    return from_splat_arrays(parse_splat_bytes(buf), device)


def save_splat(g: Gaussians, path=None) -> bytes:
    """Serialize Gaussians to .splat bytes (written to `path` if given).
    Only the degree-0 color survives (the DC term)."""
    n = g.n
    means = to_host(g.means)
    scales = to_host(g.scales)
    quats = to_host(g.normalized_quats())
    opac = to_host(g.opacities)
    rgb = np.clip(0.5 + SH_C0 * to_host(g.sh[:, 0, :]), 0.0, 1.0)

    out = np.zeros((n, ROW_LENGTH), np.uint8)
    out[:, :12] = means.astype("<f4").view(np.uint8).reshape(n, 12)
    out[:, 12:24] = scales.astype("<f4").view(np.uint8).reshape(n, 12)
    out[:, 24:27] = np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)
    out[:, 27] = np.clip(np.round(opac * 255.0), 0, 255).astype(np.uint8)
    out[:, 28:32] = np.clip(np.round(quats * 128.0) + 128.0, 0, 255).astype(np.uint8)

    buf = out.tobytes()
    if path is not None:
        with open(os.fspath(path), "wb") as fh:
            fh.write(buf)
    return buf


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a float32 numpy array on the host."""
    return t.detach().to("cpu", torch.float32).numpy()
