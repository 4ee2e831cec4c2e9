"""Tile-sharded rendering and training over a band mesh — the PyTorch
counterpart of gsjax/parallel/render_sharded.py.

The splat parameters are replicated on every rank; the image's tile rows
are split into bands (parallel/mesh.py). Each band projects every splat,
keeps the ones that can reach it (homesort.band_prefilter), builds their
home layout (kernel A), keeps the home rows of its rows and their halo
(homesort.slice_band_rows), expands them into the band's pairs (kernel B,
its band check at [ty0, ty0 + rows_live)) and blends the band (kernel C;
D and D′ backward), so every stage past the projection runs on the
band's share.

A training step runs a rank's bands one after another: each band renders,
takes its loss term and calls backward(), so the gradients accumulate in
.grad in band order and one band's graph is alive at a time. With a
process group, one all_reduce (SUM) then sums one flat buffer holding
every gradient, the loss and the AUX_COUNTERS (the counterpart of the
reference's three psums), and the optimizer steps. No float atomics; the
sums run in band order.

The reference picks its xla backend off a TPU ("auto", "pallas") only
because its kernels run interpreted there; here "auto" and "pallas" run
the stream path on every device (the port's kernels run wherever it
does). "xla" takes the stream path's band chain (prefilter, layout,
slice, kernel B's band bins) and blends its home-anchored bins with the
padded-list blend, so a band renders what the whole image's exact xla
render does there; only under footprint_clamp=True (and for "oracle")
does a band bin its span-clamped rects by the rect anchor. The reference
bins every xla band that way whatever footprint_clamp says, so its
sharded xla render clamps fat splats that its whole-image render does
not: the port does not copy that.
"""

from __future__ import annotations

import torch

from gsjax_torch.core.camera import Camera
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.parallel.mesh import (balanced_group_order, band_rows_balanced, band_rows_for,
                                       padded_height)
from gsjax_torch.render.binning import build_band_bins, build_tile_bins
from gsjax_torch.render.composite import composite_tiles
from gsjax_torch.render.project import project
from gsjax_torch.render.stream import composite_tiles_stream


def _render_band(g, cam: Camera, cfg: RenderConfig, ty0: int, band: int,
                 rows_live: int | None = None):
    """Render the tile-row band [ty0, ty0 + band): (img [band·ts,
    tiles_x·ts, 3], aux). `rows_live` (default band): the rows the band
    owns under an equal-content split; the prefilter, slice and kernel B
    bound their content to [ty0, ty0 + rows_live) while every shape
    stays band-sized. The stream and exact xla paths' n_band_overflow
    counts the splats the prefilter and the home rows the slice
    dropped."""
    backend = "stream" if cfg.backend in ("auto", "pallas") else cfg.backend
    cam = cam.to(g.device)
    p = project(g, cam, cfg)
    if backend != "stream" and (backend != "xla" or cfg.footprint_clamp):
        # the rect anchor's span-clamped bins: legacy xla, and the oracle
        bins = build_tile_bins(p, cam, cfg, ty0=ty0, band_rows=band)
        return composite_tiles(p, bins, cam, cfg)
    p, layout, bins, n_pref, n_sliced = build_band_bins(p, cam, cfg, ty0, band, rows_live)
    if backend == "xla":
        img, aux = composite_tiles(p, bins, cam, cfg)
        aux["n_fat_overflow"] = layout.n_fat_overflow
        aux["n_band_overflow"] = torch.zeros_like(layout.n_fat_overflow)
    else:
        img, aux = composite_tiles_stream(p, layout, bins, cam, cfg)
    aux["n_band_overflow"] = aux["n_band_overflow"] + n_sliced + n_pref
    return img, aux


def render_sharded(g, cam: Camera, cfg: RenderConfig, mesh, return_aux: bool = False):
    """Render with the tile rows split over the mesh's bands: [padded_H,
    tiles_x·ts, 3] on every rank, the bands in order (crop to
    [:cam.height, :cam.width]). Without a group it is differentiable;
    with one the ranks' bands are summed into one image (each row is one
    band's) by an all_reduce, which autograd does not see. With
    return_aux, (img, {counter: 0-d int64}): the AUX_COUNTERS summed over
    this rank's bands."""
    mesh.check(g)
    band = band_rows_for(cfg, cam.height, mesh.n_bands)
    outs = [_render_band(g, cam, cfg, d * band, band) for d in mesh.owned_bands()]
    imgs = [img for img, _ in outs]
    if mesh.group is None:
        full = torch.cat(imgs)
    else:
        rows = band * cfg.tile_size
        full = imgs[0].new_zeros((mesh.n_bands * rows,) + tuple(imgs[0].shape[1:]))
        for d, img in zip(mesh.owned_bands(), imgs):
            full[d * rows:(d + 1) * rows] = img.detach()
        full = mesh.all_reduce_(full)
    if not return_aux:
        return full
    counters = sum(_aux_counters(aux, full.device) for _, aux in outs)
    return full, dict(zip(AUX_COUNTERS, counters.unbind()))


#: the scalar counters a train step returns, summed over the bands:
#: every budget of the sharded path (a band's prefilter and slice drops
#: in n_band_overflow included) is counted, never silent
AUX_COUNTERS = (
    "n_clamped",
    "n_pairs",
    "n_tile_overflow",
    "n_pair_overflow",
    "n_band_overflow",
    "n_fat_overflow",
)
# the counters ride the float32 buffer of the all-reduce as (c // 4096,
# c % 4096): the sums of int32 counts are exact up to 32 ranks
_COUNTER_SPLIT = 4096


def _aux_counters(aux, device) -> torch.Tensor:
    """The AUX_COUNTERS of a band's aux as one int64 [6] tensor (0 where
    a backend has no such counter)."""
    return torch.stack([torch.as_tensor(aux.get(k, 0), device=device).to(torch.int64).reshape(())
                        for k in AUX_COUNTERS])


def _image_px(cam: Camera, cfg: RenderConfig) -> int:
    """The tile-rounded image's pixel count, every split's loss normalizer
    (so the contiguous, equalized and balanced splits give the same
    loss)."""
    return cfg.tiles_y(cam.height) * cfg.tile_size * cfg.tiles_x(cam.width) * cfg.tile_size


def _band_loss(img, tband, r0: int, n_rows: int, cam: Camera, n_el: int):
    """Σ (img − tband)² / n_el over the first n_rows rows of a band image
    whose row 0 is image row r0 (tband: the target's rows from there), the
    pixels of the image only: the last tile row's and column's pixels past
    cam.height / cam.width are rendered but are no pixels of the image,
    so the sharded loss is the whole image's (the reference counts them
    against the zero pad)."""
    k = max(min(n_rows, cam.height - r0), 0)
    return torch.sum((img[:k, :cam.width] - tband[:k, :cam.width]) ** 2) / n_el


def _reduce(mesh, params, loss, counters):
    """Sum the gradients of `params`, the loss and the counters over the
    mesh's group: one all_reduce of one flat float32 buffer."""
    if mesh.group is None:
        return loss, counters
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    flat = torch.cat([gr.reshape(-1) for gr in grads]
                     + [loss.reshape(1), (counters // _COUNTER_SPLIT).to(torch.float32),
                        (counters % _COUNTER_SPLIT).to(torch.float32)])
    mesh.all_reduce_(flat)
    o = 0
    for gr in grads:
        gr.copy_(flat[o:o + gr.numel()].view_as(gr))
        o += gr.numel()
    k = counters.shape[0]
    hi, lo = flat[o + 1:o + 1 + k], flat[o + 1 + k:]
    return flat[o], hi.to(torch.int64) * _COUNTER_SPLIT + lo.to(torch.int64)


def _step(g, mesh, optimizer, band_terms):
    """One training step of g on the mesh: for each owned band, each
    (loss term, aux) of band_terms(d) backward in turn; then the
    all-reduce and the optimizer's step. Returns (loss, {counter: 0-d
    int64})."""
    mesh.check(g)
    optimizer.zero_grad(set_to_none=True)
    loss = counters = None
    for d in mesh.owned_bands():
        for term, aux in band_terms(d):
            term.backward()
            c = _aux_counters(aux, term.device)
            loss = term.detach() if loss is None else loss + term.detach()
            counters = c if counters is None else counters + c
    params = [p for grp in optimizer.param_groups for p in grp["params"]]
    loss, counters = _reduce(mesh, params, loss, counters)
    optimizer.step()
    return loss, dict(zip(AUX_COUNTERS, counters.unbind()))


def make_train_step(cam: Camera, cfg: RenderConfig, mesh, optimizer):
    """A tile-sharded training step over equal-row bands: step(g, target)
    → (loss, aux), render → squared error summed over the band's image
    pixels / (the tile-rounded image's pixels · 3) → backward a band
    (_band_loss), the all-reduce,
    optimizer.step() (g updated in place; the optimizer holds g's
    parameters); aux the AUX_COUNTERS summed over the bands. `target` is
    the padded full image on every rank (pad_target), each band reads
    its own rows."""
    band = band_rows_for(cfg, cam.height, mesh.n_bands)
    rows = band * cfg.tile_size
    n_el = _image_px(cam, cfg) * 3

    def step(g, target):
        def band_terms(d):
            img, aux = _render_band(g, cam, cfg, d * band, band)
            yield _band_loss(img, target[d * rows:], d * rows, rows, cam, n_el), aux

        return _step(g, mesh, optimizer, band_terms)

    return step


def _pad(target, rows: int, cols: int, device):
    t = torch.as_tensor(target, dtype=torch.float32, device=device)
    return torch.nn.functional.pad(t, (0, 0, 0, cols - t.shape[1], 0, rows - t.shape[0]))


def pad_target(cfg: RenderConfig, cam: Camera, target, n_devices: int, device=None):
    """Zero-pad a [H, W, 3] target to the sharded render's [padded_H,
    tiles_x·ts, 3] (on `device`, default the target's own)."""
    return _pad(target, padded_height(cfg, cam.height, n_devices),
                cfg.tiles_x(cam.width) * cfg.tile_size, device)


# --------------------------------------------------------------------------
# equal-content bands (rows per band from autotune.derive_row_cuts)
# --------------------------------------------------------------------------


def make_train_step_equalized(cam: Camera, cfg: RenderConfig, mesh, optimizer, row_cuts):
    """A tile-sharded training step over an equal-CONTENT row partition:
    band d owns tile rows [row_cuts[d], row_cuts[d+1]) (cuts from
    autotune.derive_row_cuts, so each band holds about the same candidate
    mass). Every band renders at the largest band's row count with its
    own rows live (_render_band's rows_live) and takes the loss of its
    owned image rows only, so the bands' terms sum to the whole image's
    loss.
    `target`: pad_target_rows' padded full image on every rank."""
    cuts = [int(c) for c in row_cuts]
    if len(cuts) != mesh.n_bands + 1:
        raise ValueError(f"{len(cuts)} cuts for {mesh.n_bands} bands")
    rows_d = [cuts[i + 1] - cuts[i] for i in range(mesh.n_bands)]
    band_max = max(rows_d)
    ts = cfg.tile_size
    n_el = _image_px(cam, cfg) * 3

    def step(g, target):
        def band_terms(d):
            img, aux = _render_band(g, cam, cfg, cuts[d], band_max, rows_d[d])
            r0 = cuts[d] * ts
            yield _band_loss(img, target[r0:], r0, rows_d[d] * ts, cam, n_el), aux

        return _step(g, mesh, optimizer, band_terms)

    return step


def pad_target_rows(cfg: RenderConfig, cam: Camera, target, band_max: int, device=None):
    """Zero-pad a [H, W, 3] target to tiles_x·ts columns and (tiles_y +
    band_max) tile rows, so every band's window lies inside it."""
    return _pad(target, (cfg.tiles_y(cam.height) + band_max) * cfg.tile_size,
                cfg.tiles_x(cam.width) * cfg.tile_size, device)


# --------------------------------------------------------------------------
# balanced bands: device d renders row groups d and d + D
# --------------------------------------------------------------------------


def make_train_step_balanced(cam: Camera, cfg: RenderConfig, mesh, optimizer):
    """A tile-sharded training step with the balanced split: the image in
    2D row groups, device d renders groups d and d + D (one from each
    half, so a center-heavy scene gives every device one dense and one
    sparse group). The loss is a sum over pixels, so only the target's
    row order changes: pass pad_target_balanced's."""
    n_dev = mesh.n_bands
    gband = band_rows_balanced(cfg, cam.height, n_dev)
    gh = gband * cfg.tile_size
    n_el = _image_px(cam, cfg) * 3

    def step(g, target):
        def band_terms(d):
            for k, grp in enumerate((d, d + n_dev)):
                img, aux = _render_band(g, cam, cfg, grp * gband, gband)
                tband = target[(2 * d + k) * gh:]  # the group's rows in the permuted target
                yield _band_loss(img, tband, grp * gh, gh, cam, n_el), aux

        return _step(g, mesh, optimizer, band_terms)

    return step


def pad_target_balanced(cfg: RenderConfig, cam: Camera, target, n_devices: int,
                        device=None):
    """Pad a [H, W, 3] target and put its row groups in the balanced
    split's order (device d's share: groups d, d + D)."""
    gh = band_rows_balanced(cfg, cam.height, n_devices) * cfg.tile_size
    pw = cfg.tiles_x(cam.width) * cfg.tile_size
    t = _pad(target, 2 * n_devices * gh, pw, device)
    order = torch.tensor(balanced_group_order(n_devices), device=t.device)
    return t.reshape(2 * n_devices, gh, pw, 3)[order].reshape(-1, pw, 3)
