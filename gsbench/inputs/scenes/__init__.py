"""Synthetic scenes drawn on the device from the run's seed.

Frozen copies of the distributions of `gsjax_torch/bench/synth.py`
(`bonsai_like`, `garden_like`) and of `bench/run.py::perturb`, so the
yardstick does not move when the port's own generators do. The draws are
made with one `torch.Generator` on the scene's device, a few large calls
each, in float32; they are not the numpy streams of the originals (the
same seed gives another scene of the same distribution).

A scene is returned as its raw training parameters, the five tensors the
port's `Gaussians(means, log_scales, quats, sh, opacity_logits)` takes and
the reference reads: the benchmark hands the same tensors (cloned) to
both sides.

A configuration names its generator (`scene.generator`): the module
gsbench/inputs/scenes/<generator>.py, whose generate(n, sh_degree, seed,
offset, device) draws the scene. A new generator is a new file.
"""

from __future__ import annotations

import torch

from gsbench import harness

FIELDS = ("means", "log_scales", "quats", "sh", "opacity_logits")
SH_K = {0: 1, 1: 4, 2: 9, 3: 16}


def generator(seed: int, offset: int, device) -> torch.Generator:
    """The run's generator on `device` for one draw (`offset` tells the
    draws of one seed apart)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(offset)) % (1 << 63))
    return gen


def beta22(u3: torch.Tensor) -> torch.Tensor:
    """Beta(2, 2) from [n, 3] uniforms: the median of three (the 2nd order
    statistic of 3 uniforms has density 6x(1 - x))."""
    return torch.median(u3, dim=1).values


def finish(means, log_scales, q, opac, sh):
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    opac = torch.clamp(opac, 1e-6, 1.0 - 1e-6)
    return {"means": means.contiguous(), "log_scales": log_scales.contiguous(),
            "quats": q.contiguous(), "sh": sh.contiguous(),
            "opacity_logits": (torch.log(opac) - torch.log1p(-opac)).contiguous()}


def make_scene(spec: dict, seed: int, device) -> dict:
    """The scene a configuration's `scene` entry names: {"generator",
    "n", "sh_degree", "seed_offset"}."""
    mod = harness.module_at("inputs/scenes", spec["generator"])
    return mod.generate(int(spec["n"]), int(spec["sh_degree"]), seed,
                        int(spec["seed_offset"]), device)


def perturb(params: dict, sd: dict, seed: int, offset: int) -> dict:
    """bench.py::perturb's noise on the raw parameters named in `sd`
    ({field: standard deviation}; bench.py's: means 2e-3, sh 2e-2,
    opacity_logits 5e-2), drawn in one call; the other fields are copied."""
    dev = params["means"].device
    gen = generator(seed, offset, dev)
    names = [f for f in FIELDS if f in sd]
    sizes = [params[f].numel() for f in names]
    z = torch.split(torch.randn(sum(sizes), generator=gen, device=dev), sizes)
    out = {f: params[f].clone() for f in FIELDS}
    for f, zf in zip(names, z):
        out[f] = out[f] + float(sd[f]) * zf.view_as(out[f])
    return out
