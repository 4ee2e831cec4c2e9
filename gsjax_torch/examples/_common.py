"""What the example apps share: the demo scene, the output directory,
the scene loader, the budgets sized over an app's renders, the command
line and the overflow line — the PyTorch counterpart of
examples/_common.py."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from gsjax_torch.core.autotune import derive_caps, measure_occupancy
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.core.gaussians import Gaussians
from gsjax_torch.io.ply import load_ply
from gsjax_torch.io.splat import load_splat

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")

#: resolve_fat_caps' ceiling (render/homesort.py): the largest copy
#: budgets a scene-scaled configuration takes
CEILING = dict(fat_cap=4_194_304, fat_live_cap=2_097_152)

#: the reference examples' view: from (0, -1, -1) toward (0, 0, 4)
EYE, AT = (0.0, -1.0, -1.0), (0.0, 0.0, 4.0)

#: the counters that count dropped or clamped work (bench.run's gate)
OVERFLOW_KEYS = ("n_fat_overflow", "n_pair_overflow", "n_tile_overflow", "n_band_overflow",
                 "n_clamped")


def out_path(out, *parts) -> str:
    """The path of parts under the output directory `out` (default
    gsjax_torch/examples/out/), made when first written to."""
    path = os.path.join(out or OUT, *parts)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def demo_scene(n: int = 4000, sh_degree: int = 1, seed: int = 0,
               device="cuda") -> Gaussians:
    """A colourful synthetic blob cloud in front of the origin, the
    reference example's stand-in for bonsai-7k.splat: the same numpy draws
    in the same order, so both packages start from the same activated
    values. The raw log-scales and opacity logits are torch's logs of
    them, which may sit an ulp from another library's."""
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 0.8, (n, 3)) * np.array([1.2, 0.8, 1.0])
    means[:, 2] += 4.0
    scales = rng.uniform(0.02, 0.1, (n, 3))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.4, 0.95, n)
    k = {0: 1, 1: 4, 2: 9, 3: 16}[sh_degree]
    sh = rng.normal(size=(n, k, 3)) * 0.25
    # DC from position: a smooth rainbow
    sh[:, 0, :] = 0.5 + 0.5 * np.tanh(means / 1.5)
    return Gaussians.from_activated(means=means, scales=scales, quats=quats, opacities=opac,
                                    sh=sh, device=device)


def load_or_demo(path, device="cuda", **demo_kwargs) -> Gaussians:
    """The scene at `path` (.ply, else .splat), or the demo scene."""
    if path is None:
        return demo_scene(device=device, **demo_kwargs)
    if os.fspath(path).endswith(".ply"):
        return load_ply(path, device=device)
    return load_splat(path, device=device)


def sized_config(scenes, cams, **cfg_kwargs):
    """RenderConfig(**cfg_kwargs) with the budgets derive_caps sizes over
    every (scene, camera) an app renders, so no fat copy and no pair is
    dropped: the scene-scaled defaults drop fat copies of a dense view
    (n + n//4 live copy rows). `scenes`: one scene or a list.

    Each view's counts are those of a measuring pass at resolve_fat_caps'
    ceiling (CEILING), taken at smaller tables: a pass that drops nothing
    counts every copy and pair, as the ceiling's does. A view is measured
    at the scene-scaled caps first; where they overflow, again with a
    copy slot and a live row for each copy slot it enumerated (its
    n_copies, which no cap bounds), each at most the ceiling's. If that
    overflows, derive_caps raises. Returns (cfg, demand): the measured
    demand, the most over the views of the live copy rows ("copies"),
    the copy slots enumerated ("copy_slots") and the live pairs
    ("pairs"), and the measuring passes run ("passes": each launches
    kernels A and B once on the card)."""
    scenes = scenes if isinstance(scenes, (list, tuple)) else [scenes]
    base = RenderConfig(**cfg_kwargs)
    ms, passes = [], 0
    for g in scenes:
        for cam in cams:
            m = measure_occupancy(g, cam, base)
            passes += 1
            if m["n_fat_overflow"]:
                passes += 1
                slots = min(-(-m["n_copies"] // 8192) * 8192, CEILING["fat_cap"])
                m = measure_occupancy(g, cam, dataclasses.replace(
                    base, fat_cap=slots, fat_live_cap=min(slots, CEILING["fat_live_cap"])))
            ms.append(m)
    ceiling = dataclasses.replace(base, **CEILING)
    cfg = derive_caps(scenes[0], cams, ceiling, ms=ms)
    demand = {"copies": max(m["n_valid"] - m["n_live_prim"] for m in ms),
              "copy_slots": max(m["n_copies"] for m in ms),
              "pairs": max(m["n_pairs"] for m in ms), "passes": passes}
    return cfg, demand


class Overflow:
    """The largest of each overflow counter over an app's renders and
    steps: called with each render's aux (the maxima stay on the device
    until read)."""

    def __init__(self):
        self.n = 0
        self._worst = {}

    def __call__(self, aux) -> None:
        self.n += 1
        for k in OVERFLOW_KEYS:
            if k in aux:
                v = torch.as_tensor(aux[k]).to(torch.int64)
                self._worst[k] = v if k not in self._worst else torch.maximum(self._worst[k], v)

    def counts(self) -> dict:
        return {k: int(self._worst[k]) if k in self._worst else 0 for k in OVERFLOW_KEYS}


def parser(doc: str, scene: bool = True) -> argparse.ArgumentParser:
    """The apps' command line: [scene] [--device cuda|cpu] [--out DIR]."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    if scene:
        ap.add_argument("scene", nargs="?", default=None,
                        help="a scene file (the demo scene when left out)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the scene's tensors live (default cuda; no fallback)")
    ap.add_argument("--out", default=None, help=f"output directory (default {OUT})")
    return ap


def overflow_line(result: dict) -> str:
    """An app's last line: the largest of each overflow counter over its
    renders and steps."""
    return (f"overflow, the largest over {result['renders']} renders and steps: "
            + json.dumps(result["overflow"]))
