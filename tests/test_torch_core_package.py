"""gsjax_torch: the package's independence from JAX, and the one entry
point left to port."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gsjax_torch as gt
from gsjax_torch.bench import synth as tsynth
from gsjax_torch.render.passes import depth_fade

torch.set_num_threads(2)


def test_package_imports_no_jax():
    """Importing every gsjax_torch module, and building and loading the
    native PLY parser, leaves no jax / gsjax module loaded (fresh
    interpreter: the test process itself has jax)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import importlib, pkgutil, sys\n"
        "import gsjax_torch\n"
        "for m in pkgutil.walk_packages(gsjax_torch.__path__, 'gsjax_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "    print('walked', m.name)\n"
        "import gsjax_torch.io.native as native\n"
        "native.lib()\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'gsjax'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    walked = {line.split()[1] for line in res.stdout.splitlines() if line.startswith("walked")}
    for m in ("io.native", "io.ply", "io.qply", "io.splat", "io.stream", "core.autotune",
              "core.banded", "core.transforms", "render.oracle", "render.passes",
              "camera.controls", "camera.json_io", "parallel.mesh", "parallel.render_sharded",
              "parallel.dryrun", "parallel.mp_worker", "examples._common",
              "examples.simple_viewer", "examples.file_loader", "examples.ply_converter",
              "examples.scene_transformations", "examples.camera_updates",
              "examples.train_fit", "examples.sharded_render"):
        assert f"gsjax_torch.{m}" in walked, m


def test_unported_paths_raise(rng):
    """No entry point raises as unported any more: tile-sharded training
    (train.fit(mesh=...)) takes a step over a band mesh; the paths that
    raised before the reference backends and the viewer loop were ported
    run: the oracle and xla backends, forward and backward, legacy mode
    and passes on every backend, and the fade-in."""
    from gsjax_torch.parallel.mesh import make_mesh

    gp = tsynth.bonsai_like(n=200, seed=0, device="cpu")
    cam = gt.Camera.create(position=(0.0, 0.0, -4.0), fx=60.0, fy=60.0,
                           width=32, height=32, device="cpu")
    _, losses = gt.train.fit(gp, [cam], [torch.zeros(32, 32, 3)], steps=1,
                             mesh=make_mesh(2, "cpu"))
    assert len(losses) == 1 and np.isfinite(losses[0])
    # every backend's backward reaches every field, exact and legacy
    for backend in ("oracle", "xla", "stream", "pallas"):
        for clamp in (False, True):
            gp.zero_grad(set_to_none=True)
            cfg = gt.RenderConfig(backend=backend, chunk=32, tile_list_cap=256,
                                  footprint_clamp=clamp)
            img = gt.render(gp, cam, cfg, passes=[depth_fade(0.05)])
            img.sum().backward()
            for name, p in gp.named_parameters():
                assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
            assert float(gp.opacity_logits.grad.abs().max()) > 0, backend
    frames = gt.render_trajectory(gp, [cam, cam], fade_in=True, fade_speed=50.0)
    assert frames.shape == (2, 32, 32, 3) and np.isfinite(frames).all()
