"""gsjax_torch against tests/test_golden.py's independent rasterizer: the
hand-derived numpy rendering of the published 3DGS math (per-pixel
loops, no code shared with either package) on its curated cases (SH
degree 3, anisotropy, termination-heavy stacks, the image's edge, the
alpha clamp and floor, a whole-image splat, splats behind the camera),
through all four of the port's backends with test_golden.py's
configurations.

Tolerance: max |Δ| < 1e-4 on every case and backend — test_golden.py's
gate for gsjax's oracle (exact exp, f32 against f64). The port's binned
backends read exact f32 attributes, so they are held to it too, tighter
than test_golden.py's gates for gsjax's fast backends (p99.5 < 1e-3, max
< 2e-2), which read a bf16 split table on the TPU."""

import numpy as np
import pytest
import torch

import gsjax_torch as gt
from test_golden import _cam, _cases, golden_render

torch.set_num_threads(2)

_FIELDS = ("means", "log_scales", "quats", "sh", "opacity_logits")
# tests/test_golden.py's BACKENDS (the stream band knobs are TPU scratch
# sizes, no-ops in the port)
BACKENDS = {
    "oracle": gt.RenderConfig(backend="oracle"),
    "xla": gt.RenderConfig(backend="xla", tile_list_cap=512, chunk=32, tile_span=9),
    "pallas": gt.RenderConfig(backend="pallas", chunk=32, tile_span=9),
    "stream": gt.RenderConfig(backend="stream", chunk=32, fat_max_blocks=64, fat_cap=512),
}


@pytest.fixture(scope="module")
def goldens():
    rng = np.random.default_rng(7)
    cam = _cam()
    camt = gt.Camera.create(position=np.array(cam.position), quat=np.array(cam.quat),
                            fx=float(cam.fx), fy=float(cam.fy), width=cam.width,
                            height=cam.height, device="cpu")
    return camt, {name: (gt.Gaussians.from_numpy(*(np.asarray(getattr(g, f)) for f in _FIELDS),
                                                 device="cpu"), golden_render(g, cam))
                  for name, g in _cases(rng).items()}


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_backends_match_golden(goldens, backend):
    cam, cases = goldens
    assert len(cases) == 9
    with torch.no_grad():
        for name, (g, gold) in cases.items():
            assert gold.max() > 0.05, name  # a case that renders something
            img, aux = gt.render(g, cam, BACKENDS[backend], return_aux=True)
            d = np.abs(img.numpy().astype(np.float64) - gold)
            assert d.max() < 1e-4, (name, d.max())
            assert not any(int(v) for k, v in aux.items() if k.endswith("overflow")), name
