"""Helpers of the blend forward tests (test_torch_blend_fwd*.py): pair
rows, conics and the 400-splat scene's blend inputs."""

import dataclasses

import numpy as np
import torch

from conftest import make_random_scene

import gsjax_torch as gt
from gsjax_torch.render.binning import build_tile_bins
from gsjax_torch.render.composite import att_table, clipped_pair_stream
from gsjax_torch.render.homesort import build_home_layout
from gsjax_torch.render.project import project

torch.set_num_threads(2)

_FIELDS = ("means", "log_scales", "quats", "sh", "opacity_logits")
W, H, CHUNK, K, TS = 96, 64, 32, 9, 16
X0, Y0 = 48.0, 32.0  # the test tile's top-left pixel


def _conics(rng, n, ratio):
    """n conics (a, b, c) of covariances with axes σ1 ∈ [0.2, 200] px and
    σ1 / σ2 ∈ ratio (log-uniform), at random angles."""
    s1 = np.exp(rng.uniform(np.log(0.2), np.log(200.0), n))
    s2 = s1 / np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1]), n))
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    # the inverse of R diag(s1², s2²) Rᵀ
    i1, i2 = 1.0 / s1 ** 2, 1.0 / s2 ** 2
    return np.stack([c * c * i1 + s * s * i2, c * s * (i1 - i2), s * s * i1 + c * c * i2], -1)


def _pairs(seed=3):
    """Pair rows [n, 9] (mean2d, conic, rgb, opacity) f32 around the tile at
    (X0, Y0): round, tiny, huge and needle-thin conics and a few that are
    degenerate or not positive definite; opacities below α_min, at it, one
    ulp above, just above, random, at α_clamp and 1; means in and near the
    tile, far off it, and placed so the ellipse's α_min edge passes through
    a pixel centre of the tile (or a hair inside or outside it): random
    ellipses, round ones at a warp rectangle's corner pixel, and needles
    whose axis runs through a pixel."""
    rng = np.random.default_rng(seed)
    cfg = gt.RenderConfig()
    amin = np.float32(cfg.alpha_min)
    conic = np.concatenate([_conics(rng, 1500, (1.0, 4.0)), _conics(rng, 1200, (4.0, 60.0)),
                            _conics(rng, 800, (60.0, 3000.0)),
                            np.array([[1.0, 1.0, 1.0], [0.5, 0.6, 0.5], [0.0, 0.0, 0.3],
                                      [1e-3, 0.0, -1e-3], [2.0, -1.9999, 2.0],
                                      [0.02, 0.01999, 0.02]] * 20)])
    n = conic.shape[0]
    op = rng.choice(np.array([amin * 0.5, np.nextafter(amin, np.float32(0)), amin,
                              np.nextafter(amin, np.float32(1)), amin * np.float32(1.001),
                              np.float32(cfg.alpha_clamp), np.float32(1.0)], np.float32), n)
    op = np.where(rng.uniform(size=n) < 0.4, rng.uniform(amin, 1.0, n), op).astype(np.float32)
    kind = rng.integers(0, 3, n)
    mean = np.where((kind == 0)[:, None], rng.uniform(-40, TS + 40, (n, 2)),
                    rng.uniform(-500, TS + 500, (n, 2)))
    # edge placement: a pixel p of the tile on the ellipse q(p − mean) = L
    p = rng.integers(0, TS, (n, 2)).astype(np.float64)
    th = rng.uniform(0, 2 * np.pi, n)
    u = np.stack([np.cos(th), np.sin(th)], -1)
    quad = (conic[:, 0] * u[:, 0] ** 2 + 2 * conic[:, 1] * u[:, 0] * u[:, 1]
            + conic[:, 2] * u[:, 1] ** 2)
    L = 2.0 * np.log(np.maximum(op.astype(np.float64), amin) / amin)
    r = np.sqrt(L / np.where(quad > 0, quad, 1.0)) * (1.0 + rng.choice([-1e-4, 0.0, 1e-4], n))
    edge = (kind == 2) & (quad > 0)
    mean = np.where(edge[:, None], p - u * r[:, None], mean)
    # round splats whose α_min circle passes a corner pixel of a warp's
    # rectangle (its point nearest the mean) within float rounding, and
    # needles aimed from far off the tile through one of its pixels
    k = 2000
    sig = np.exp(rng.uniform(np.log(0.3), np.log(50.0), k))
    op_r = rng.uniform(amin, 1.0, k).astype(np.float32)
    corner = np.stack([rng.choice([0, 7, 8, 15], k), rng.choice([0, 7, 8, 15], k)], -1)
    out = np.where(corner % 8 == 0, -1.0, 1.0)  # away from the rectangle
    th = rng.uniform(0.1, np.pi / 2 - 0.1, k)
    u = out * np.stack([np.cos(th), np.sin(th)], -1)
    r = sig * np.sqrt(2.0 * np.log(op_r / amin) * (1.0 + rng.uniform(-2e-6, 2e-6, k)))
    conic = np.concatenate([conic, np.stack([1 / sig ** 2, 0 * sig, 1 / sig ** 2], -1)])
    mean = np.concatenate([mean, corner + u * r[:, None]])
    op = np.concatenate([op, op_r])
    k = 1000
    axis = rng.uniform(0, 2 * np.pi, k)
    c, sn = np.cos(axis), np.sin(axis)
    s1 = np.exp(rng.uniform(np.log(100.0), np.log(300.0), k))  # σ2 0.01-0.1 px
    i1, i2 = 1.0 / s1 ** 2, (3000.0 / s1) ** 2 * np.exp(rng.uniform(0, np.log(10.0), k))
    conic = np.concatenate([conic, np.stack([c * c * i1 + sn * sn * i2, c * sn * (i1 - i2),
                                             sn * sn * i1 + c * c * i2], -1)])
    hit = rng.integers(0, TS, (k, 2))
    far = (s1 * rng.uniform(0.5, 1.5, k))[:, None]
    mean = np.concatenate([mean, hit + np.stack([c, sn], -1) * far])
    op = np.concatenate([op, rng.uniform(0.05, 1.0, k).astype(np.float32)])
    att = np.zeros((mean.shape[0], 9), np.float32)
    att[:, 0:2] = mean + (X0, Y0)
    att[:, 2:5] = conic
    att[:, 5:8] = rng.uniform(0, 1, (mean.shape[0], 3))
    att[:, 8] = op
    return torch.from_numpy(att), int(edge.sum())


def _scene(eps):
    """(att, pid, starts, bins, cfg): test_torch_blend_bwd.py's 400-splat
    scene at 96×64, chunk 32, transmittance_eps = eps."""
    g = make_random_scene(np.random.default_rng(11), n=400, sh_degree=1, spread=1.2,
                          z_range=(3.0, 8.0))
    g = dataclasses.replace(g, log_scales=g.log_scales + 1.0)
    gp = gt.Gaussians.from_numpy(*(np.asarray(getattr(g, f)) for f in _FIELDS),
                                 device="cpu")
    cam = gt.Camera.create(fx=80.0, fy=80.0, width=W, height=H, device="cpu")
    cfg = gt.RenderConfig(chunk=CHUNK, transmittance_eps=eps, fat_max_blocks=64,
                          fat_cap=2048)
    with torch.no_grad():
        ph, layout = build_home_layout(project(gp, cam, cfg), cam, cfg)
        bins = build_tile_bins(ph, cam, cfg, anchor="home", layout=layout)
    pid, starts, _ = clipped_pair_stream(bins, cfg)
    return att_table(ph), pid, starts, bins, cfg
