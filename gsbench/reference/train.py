"""The plain reference's training steps: render → mean squared error →
Adam, in float32, on the raw parameters (reference/render.py).

Two step semantics, the two the port trains by:

* `exact`: one Adam step on every parameter per view, the gradient of a
  splat summed over all the tiles it reaches (`train.make_step_fn`).
* `lazy`: the lazy trainer's plan and steps (`render/lazy.LazyTrainer`).
  At a resort the parameters are split into home rows: each splat in
  view whose radius rect is non-empty has a primary row, and a splat
  whose rect spans more than one block of 3×3 tiles one more row per
  further block that its α_min ellipse can reach (the blocks tile the
  rect from its top-left corner, row-major). Each row takes a copy of
  its splat's parameters and Adam moments. The rows, their pairs (the
  tiles of the row's block) and the pairs' depth order are frozen until
  the next resort. Each step projects every row afresh from its own
  parameters under the camera; a row the fresh projection culls draws
  nothing (opacity 0). A row receives the gradient of the pixels of its
  own block's tiles, and Adam steps each row apart. At the next resort
  the fold back gives each splat the mean of its rows' parameter changes
  and its primary row's moments. A splat with no row keeps its
  parameters and moments.

The rows are worked out again here from the parameters at each resort;
nothing is read from the program.
"""

from __future__ import annotations

import torch

from gsbench.reference import render as R

FIELDS = ("means", "log_scales", "quats", "sh", "opacity_logits")
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
SPAN = 3  # tiles per block side


def adam_update(p, g, m, v, t: int, lr: float):
    """torch.optim.Adam's update (bias-corrected moments, eps added to the
    corrected root), in place on p, m, v."""
    m.mul_(BETA1).add_(g, alpha=1 - BETA1)
    v.mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
    bc1 = 1 - BETA1 ** t
    bc2 = 1 - BETA2 ** t
    denom = (v.sqrt() / (bc2 ** 0.5)).add_(EPS)
    p.addcdiv_(m, denom, value=-lr / bc1)


def _rows(pr: dict, W: int, H: int, lazy: bool):
    """(row_src [R], row_primary [R] bool, pair_row [P], pair_tile [P],
    pair_src [P]) of one resort. Exact: one row per splat."""
    splat, tx, ty, (x0, y0, x1, y1, on) = R.pairs(pr, W, H)
    tile = ty * -(-W // R.TILE) + tx
    n = on.shape[0]
    if not lazy:
        src = torch.arange(n, device=on.device)
        return src, torch.ones_like(on), splat, tile, splat
    sbx = -(-(x1 - x0) // SPAN)
    sby = -(-(y1 - y0) // SPAN)
    nb = torch.where(on, sbx * sby, torch.zeros_like(sbx))
    idx = torch.nonzero(nb > 0).squeeze(1)
    src = torch.repeat_interleave(idx, nb[idx])
    b = torch.arange(src.shape[0], device=src.device) - torch.repeat_interleave(
        torch.cumsum(nb[idx], 0) - nb[idx], nb[idx])
    bx, by = b % sbx[src], b // sbx[src]
    wx0, wy0 = x0[src] + SPAN * bx, y0[src] + SPAN * by
    wx1, wy1 = torch.minimum(wx0 + SPAN, x1[src]), torch.minimum(wy0 + SPAN, y1[src])
    conic, mean = pr["conic"].detach()[src], pr["mean2d"].detach()[src]
    qmin = R.box_qmin(conic, mean, (wx0 * R.TILE).float(), (wx1 * R.TILE - 1).float(),
                      (wy0 * R.TILE).float(), (wy1 * R.TILE - 1).float())
    # the port's block cull: 2·ln(max(o, α_min)/α_min) + 1e-3
    live = (b == 0) | (qmin <= R.reach(pr["opacity"].detach()[src]) + 1e-3)
    src, b = src[live], b[live]
    key = src * 1024 + b  # rows sorted by (splat, block); a rect spans < 1024 blocks
    pb = ((ty - y0[splat]) // SPAN) * sbx[splat] + (tx - x0[splat]) // SPAN
    pkey = splat * 1024 + pb
    pos = torch.searchsorted(key, pkey).clamp(max=max(key.shape[0] - 1, 0))
    hit = key[pos] == pkey
    return src, b == 0, pos[hit], tile[hit], splat[hit]


def _loss_grad(rows: dict, cam: dict, target: torch.Tensor, pair_row, pair_tile, depth,
               tf32: bool, keep):
    """The loss of the rows' image at cam (their pairs and depth order
    fixed) against target, and its gradient {field: [R, ...]} in the rows.
    A row the projection culls draws nothing: mean 0, conic (1, 0, 1),
    opacity 0."""
    W, H = cam["width"], cam["height"]
    rows = {f: t.detach().requires_grad_(True) for f, t in rows.items()}
    pr = R.project(rows, cam, tf32)
    ok = pr["valid"][:, None]
    one_zero_one = torch.tensor([1.0, 0.0, 1.0], device=ok.device)
    att = torch.cat([torch.where(ok, pr["mean2d"], 0.0),
                     torch.where(ok, pr["conic"], one_zero_one), pr["rgb"],
                     torch.where(ok, pr["opacity"][:, None], 0.0)], -1)
    tgt = R.pad_tiles(target)
    img, d_att, _ = R.composite(att, pair_row, pair_tile, depth, W, H, tf32,
                                pixel_grad=R.pixel_loss_grad(tgt, W, H, keep))
    inside = torch.zeros(tgt.shape[:2], dtype=torch.bool, device=tgt.device)
    inside[:H, :W] = True
    if keep is not None:
        inside &= keep
    loss = float(((img - target) ** 2)[inside[:H, :W]].mean())
    torch.autograd.backward(att, d_att)
    return loss, {f: rows[f].grad for f in FIELDS}


def visit(p: dict, m: dict, v: dict, t: int, lrs: dict, cam: dict, target: torch.Tensor,
          lazy: bool, steps: int = 1, tf32: bool = False, keep=None):
    """One view's training of `p` (raw parameters, updated in place, with
    its Adam moments m, v) toward `target` [H, W, 3] at cam, from step
    number t (counted from 1): exact, one step; lazy, a resort, `steps`
    steps of its frozen plan, and the fold back. keep [H·, W·] bool, where
    given, is the pixels the loss's mean runs over. Returns (the steps'
    losses, the first step's per-splat gradient {field: [N, ...]}, summed
    over a splat's rows)."""
    if not lazy and steps != 1:
        raise ValueError("exact training takes one step per view")
    W, H = cam["width"], cam["height"]
    with torch.no_grad():
        pr0 = R.project(p, cam, tf32)
        src, primary, pair_row, pair_tile, pair_src = _rows(pr0, W, H, lazy)
        depth = pr0["depth"][pair_src]
        del pr0
    rows = {f: p[f][src].clone() for f in FIELDS}
    mr = {f: m[f][src].clone() for f in FIELDS}
    vr = {f: v[f][src].clone() for f in FIELDS}
    losses, first = [], None
    for k in range(steps):
        loss, grads = _loss_grad(rows, cam, target, pair_row, pair_tile, depth, tf32, keep)
        losses.append(loss)
        with torch.no_grad():
            if first is None:
                first = {f: torch.zeros_like(p[f]).index_add_(0, src, grads[f])
                         for f in FIELDS}
            for f in FIELDS:
                if lazy:
                    adam_update(rows[f], grads[f], mr[f], vr[f], t + k, lrs[f])
                else:
                    adam_update(p[f], first[f], m[f], v[f], t + k, lrs[f])
        del grads
    if not lazy:
        return losses, first
    n = p["means"].shape[0]
    with torch.no_grad():
        cnt = torch.zeros(n, device=src.device).index_add_(
            0, src, torch.ones(src.shape[0], device=src.device))
        prim = src[primary]
        for f in FIELDS:
            delta = torch.zeros_like(p[f]).index_add_(0, src, rows[f] - p[f][src])
            shape = (-1,) + (1,) * (p[f].dim() - 1)
            p[f] += delta / cnt.clamp(min=1).view(shape)
            m[f][prim] = mr[f][primary]
            v[f][prim] = vr[f][primary]
    return losses, first


def train(p0: dict, lrs: dict, cams: list, targets: list, lazy: bool, steps: int = 1,
          tf32: bool = False, keep=None) -> dict:
    """One visit per (camera, target) from p0 (not modified), `steps`
    steps each, fresh Adam moments. Returns {"losses": every step's, in
    order, "grad": the first step's per-splat gradient {field: tensor},
    "change": {field: p − p0} after the last fold back}."""
    p = {f: p0[f].detach().clone() for f in FIELDS}
    m = {f: torch.zeros_like(p[f]) for f in FIELDS}
    v = {f: torch.zeros_like(p[f]) for f in FIELDS}
    losses, grad0 = [], None
    for i, (cam, target) in enumerate(zip(cams, targets)):
        ls, g = visit(p, m, v, 1 + i * steps, lrs, cam, target, lazy, steps, tf32, keep)
        losses += ls
        if grad0 is None:
            grad0 = g
        del g
    return {"losses": losses, "grad": grad0,
            "change": {f: p[f] - p0[f] for f in FIELDS}}
