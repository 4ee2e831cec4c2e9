"""The plain reference: 3D Gaussian splatting forward and backward in plain
PyTorch, float32, written from graphdeco's description (Kerbl et al.
2023) and imported from nothing of the port.

Semantics (graphdeco's rasterizer, as the port states it):
  * projection: world → camera by the camera's rotation and position, the
    perspective Jacobian with the 1.3·tan(fov/2) clamp, Σ = R S Sᵀ Rᵀ,
    a 0.3 px² low-pass on the 2-D covariance, its conic, a footprint
    radius ceil(3·sqrt(λ_max)), culls (z ≤ 0.2, det ≤ 0, off screen,
    opacity < 1/255), SH colour max(Σ c·Y + 0.5, 0);
  * tile-granular support: a splat reaches the pixels of the 16×16 tiles
    of its radius rect;
  * per pixel, front to back in (depth, splat) order: α = min(0.99,
    o·exp(power)), skipped when α < 1/255 or power > 0; a splat that
    would push the transmittance below 1e-4 is left out and the pixel
    stops;
  * a black background behind the remaining transmittance.

The composite runs per tile in blocks of tiles with their pair lists
padded to the block's longest, so the timed sizes fit; its backward is
autograd's through each block, given the loss's gradient per pixel.
`tf32=True` rounds every matrix product's operands to TF32 (10-bit
mantissa, round half away, as the tensor cores' conversion does) and
accumulates in float32: the configuration's precision one step down, the
control that decides whether a comparison can fail.
"""

from __future__ import annotations

import torch

TILE = 16
NEAR = 0.2
LOWPASS = 0.3
ALPHA_MIN = 1.0 / 255.0
ALPHA_CLAMP = 0.99
T_EPS = 1e-4
RADIUS_SIGMA = 3.0
# the tile cull keeps a pair whose smallest conic quadratic over the tile
# lies within this much of the α_min contour: conservative, so it drops
# nothing a pixel would take (the per-pixel test decides)
CULL_SLACK = 1e-2
# elements of one [tiles, pixels, pairs] block tensor
BLOCK_ELEMS = 1 << 25

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10-bit mantissa, half away from zero."""
    xi = x.contiguous().view(torch.int32)
    return ((xi + 0x1000) & ~0x1FFF).view(torch.float32)


class _RoundTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return tf32_round(x)

    @staticmethod
    def backward(ctx, g):
        return tf32_round(g)


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    """torch.matmul in float32, or on TF32-rounded operands (its backward's
    products rounded alike)."""
    if tf32:
        a, b = _RoundTF32.apply(a), _RoundTF32.apply(b)
    return torch.matmul(a, b)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotations from unit (w, x, y, z) quaternions."""
    w, x, y, z = q.unbind(-1)
    rows = [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]
    return torch.stack(rows, -1).reshape(*q.shape[:-1], 3, 3)


def camera_frame(cam: dict, device):
    """(R_w2c [3, 3], t_w2c [3], position [3]) of a camera dict."""
    pos = torch.tensor(cam["position"], dtype=torch.float32, device=device)
    q = torch.tensor(cam["quat"], dtype=torch.float32, device=device)
    r_c2w = quat_to_rot(q / torch.linalg.norm(q))
    r_w2c = r_c2w.T.contiguous()
    return r_w2c, -(r_w2c @ pos), pos


def sh_basis(d: torch.Tensor, k: int) -> torch.Tensor:
    """Real SH basis [N, k] at unit directions d [N, 3], graphdeco's order."""
    out = [torch.full(d.shape[:-1], SH_C0, dtype=d.dtype, device=d.device)]
    x, y, z = d.unbind(-1)
    if k > 1:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if k > 4:
        xx, yy, zz = x * x, y * y, z * z
        out += [SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * zz - xx - yy),
                SH_C2[3] * x * z, SH_C2[4] * (xx - yy)]
    if k > 9:
        out += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
                SH_C3[2] * y * (4 * zz - xx - yy), SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                SH_C3[6] * x * (xx - 3 * yy)]
    return torch.stack(out, -1)


def project(p: dict, cam: dict, tf32: bool = False) -> dict:
    """Screen-space splats of the raw parameters `p` (means, log_scales,
    quats, sh, opacity_logits): mean2d [N, 2], depth [N], conic [N, 3]
    (a, b, c of a·dx² + 2b·dx·dy + c·dy²), radius [N], rgb [N, 3], opacity
    [N], valid [N]. Differentiable in p."""
    dev = p["means"].device
    r_w2c, t_w2c, pos = camera_frame(cam, dev)
    fx, fy, W, H = float(cam["fx"]), float(cam["fy"]), cam["width"], cam["height"]
    tc = mm(p["means"], r_w2c.T, tf32) + t_w2c
    z = tc[:, 2]
    in_front = z > NEAR
    zc = torch.where(in_front, z, torch.ones_like(z))
    limx, limy = 1.3 * W / (2.0 * fx), 1.3 * H / (2.0 * fy)
    tx = torch.clamp(tc[:, 0] / zc, -limx, limx) * zc
    ty = torch.clamp(tc[:, 1] / zc, -limy, limy) * zc
    zero = torch.zeros_like(z)
    jac = torch.stack([fx / zc, zero, -fx * tx / (zc * zc),
                       zero, fy / zc, -fy * ty / (zc * zc)], -1).reshape(-1, 2, 3)
    T = mm(jac, r_w2c, tf32)
    q = p["quats"]
    q = q / torch.sqrt(torch.sum(q * q, -1, keepdim=True) + 1e-24)
    M = quat_to_rot(q) * torch.exp(p["log_scales"])[:, None, :]
    A = mm(T, M, tf32)
    cov = mm(A, A.transpose(1, 2), tf32)
    c00, c01, c11 = cov[:, 0, 0] + LOWPASS, cov[:, 0, 1], cov[:, 1, 1] + LOWPASS
    det = c00 * c11 - c01 * c01
    det_ok = det > 0
    det = torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c11 / det, -c01 / det, c00 / det], -1)
    mid = 0.5 * (c00 + c11)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(RADIUS_SIGMA * torch.sqrt(lam)).detach()
    mean2d = torch.stack([fx * tc[:, 0] / zc + (W - 1) * 0.5,
                          fy * tc[:, 1] / zc + (H - 1) * 0.5], -1)
    on_screen = ((mean2d[:, 0] + radius >= 0) & (mean2d[:, 0] - radius < W)
                 & (mean2d[:, 1] + radius >= 0) & (mean2d[:, 1] - radius < H)).detach()
    opacity = torch.sigmoid(p["opacity_logits"])
    d = p["means"] - pos
    d = d / torch.sqrt(torch.sum(d * d, -1, keepdim=True) + 1e-24)
    basis = sh_basis(d, p["sh"].shape[1])
    rgb = torch.clamp(mm(basis[:, None, :], p["sh"], tf32)[:, 0] + 0.5, min=0.0)
    valid = (in_front & det_ok & on_screen & (opacity >= ALPHA_MIN)).detach()
    return {"mean2d": mean2d, "depth": z, "conic": conic, "radius": radius,
            "rgb": rgb, "opacity": opacity, "valid": valid}


def attributes(pr: dict) -> torch.Tensor:
    """The blend's per-splat table [N, 9]: mean2d, conic, rgb, opacity."""
    return torch.cat([pr["mean2d"], pr["conic"], pr["rgb"], pr["opacity"][:, None]], -1)


def tile_rect(pr: dict, W: int, H: int):
    """graphdeco's getRect: tile rect [x0, x1) × [y0, y1) of each splat's
    radius, clipped to the image's tiles; (x0, y0, x1, y1, on)."""
    tx, ty = -(-W // TILE), -(-H // TILE)
    m = pr["mean2d"].detach()
    r = pr["radius"]
    edge = lambda v, hi: torch.clamp(torch.floor(v / TILE), 0, hi).to(torch.int64)
    x0, x1 = edge(m[:, 0] - r, tx), edge(m[:, 0] + r + TILE - 1, tx)
    y0, y1 = edge(m[:, 1] - r, ty), edge(m[:, 1] + r + TILE - 1, ty)
    on = pr["valid"] & (x1 > x0) & (y1 > y0)
    return x0, y0, x1, y1, on


def box_qmin(conic, mean, px0, px1, py0, py1):
    """Smallest a·dx² + 2b·dx·dy + c·dy² over the pixel box [px0, px1] ×
    [py0, py1] (offsets from `mean`): 0 with the mean inside, else the
    least of the four edges' minima."""
    a, b, c = conic.unbind(-1)
    dxl, dxr = px0 - mean[..., 0], px1 - mean[..., 0]
    dyl, dyr = py0 - mean[..., 1], py1 - mean[..., 1]
    q = lambda dx, dy: a * dx * dx + 2 * b * dx * dy + c * dy * dy
    ex = lambda dx: q(dx, torch.minimum(torch.maximum(-b * dx / c, dyl), dyr))
    ey = lambda dy: q(torch.minimum(torch.maximum(-b * dy / a, dxl), dxr), dy)
    m = torch.minimum(torch.minimum(ex(dxl), ex(dxr)), torch.minimum(ey(dyl), ey(dyr)))
    inside = (dxl <= 0) & (dxr >= 0) & (dyl <= 0) & (dyr >= 0)
    return torch.where(inside, torch.zeros_like(m), m)


def reach(opacity: torch.Tensor) -> torch.Tensor:
    """The largest conic quadratic at which a splat still reaches α_min."""
    return 2.0 * torch.log(torch.clamp(opacity, min=ALPHA_MIN) / ALPHA_MIN)


def pairs(pr: dict, W: int, H: int):
    """Every (splat, tile) of the splats' rects whose tile the splat's
    α_min ellipse can reach, in splat order: (splat [P], tx [P], ty [P],
    and the rects (x0, y0, x1, y1, on))."""
    x0, y0, x1, y1, on = tile_rect(pr, W, H)
    idx = torch.nonzero(on).squeeze(1)
    w = (x1 - x0)[idx]
    cnt = w * (y1 - y0)[idx]
    splat = torch.repeat_interleave(idx, cnt)
    base = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
    k = torch.arange(splat.shape[0], device=splat.device) - base
    wr = torch.repeat_interleave(w, cnt)
    tx = x0[splat] + k % wr
    ty = y0[splat] + k // wr
    del base, k, wr
    conic, mean = pr["conic"].detach()[splat], pr["mean2d"].detach()[splat]
    qmin = box_qmin(conic, mean, (tx * TILE).float(), (tx * TILE + TILE - 1).float(),
                    (ty * TILE).float(), (ty * TILE + TILE - 1).float())
    keep = qmin <= reach(pr["opacity"].detach()[splat]) + CULL_SLACK
    return splat[keep], tx[keep], ty[keep], (x0, y0, x1, y1, on)


def composite(att: torch.Tensor, pair_row: torch.Tensor, pair_tile: torch.Tensor,
              pair_depth: torch.Tensor, W: int, H: int, tf32: bool = False,
              pixel_grad=None, count: bool = False):
    """Blend the pairs (row of `att` [R, 9], tile, depth) of an image W×H.

    Returns (img [H, W, 3], d_att [R, 9] or None, counts or None).
    pixel_grad(img_tiles [B, 256, 3], tile ids [B]) → d loss / d img of
    those tiles' pixels (zero outside the image) asks for the backward:
    d_att accumulates autograd's gradient of each block. count=True also
    returns the work the blend needs: eligible pair-pixels before the
    pixel stopped (`pp_live`), included ones (`pp_included`), pairs,
    rows with a pair, pixels."""
    dev = att.device
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    n_tiles = tiles_x * tiles_y
    key = pair_tile * (1 << 32) + pair_depth.detach().contiguous().view(torch.int32).to(
        torch.int64)
    order = torch.sort(key, stable=True).indices
    row, tile = pair_row[order], pair_tile[order]
    del key, order
    cnt = torch.bincount(tile, minlength=n_tiles)
    starts = torch.cumsum(cnt, 0) - cnt
    by_len = torch.argsort(cnt, descending=True)
    cnt_h = cnt[by_len].tolist()
    att_d = att.detach()
    d_att = torch.zeros_like(att_d) if pixel_grad is not None else None
    img = torch.zeros((tiles_y * TILE, tiles_x * TILE, 3), device=dev)
    work = {"pp_live": 0, "pp_included": 0, "pairs": int(row.shape[0]),
            "rows": int(torch.unique(row).shape[0]) if count else 0,
            "pixels": W * H} if count else None
    ly = torch.arange(TILE * TILE, device=dev) // TILE
    lx = torch.arange(TILE * TILE, device=dev) % TILE
    i = 0
    while i < n_tiles:
        L = max(cnt_h[i], 1)
        B = max(1, min(n_tiles - i, BLOCK_ELEMS // (TILE * TILE * L)))
        tb = by_len[i:i + B]
        i += B
        li = torch.arange(L, device=dev)
        valid = li[None, :] < cnt[tb][:, None]
        idx = torch.clamp(starts[tb][:, None] + li[None, :], max=max(row.shape[0] - 1, 0))
        rows = row[idx] if row.shape[0] else torch.zeros_like(idx)
        a = att_d[rows]
        if d_att is not None:
            a.requires_grad_(True)
        px = ((tb % tiles_x) * TILE)[:, None] + lx[None, :]
        py = ((tb // tiles_x) * TILE)[:, None] + ly[None, :]
        with torch.set_grad_enabled(d_att is not None):
            out, live_n, inc_n = _blend_block(a, valid, px.float(), py.float(), tf32, count)
        if count:
            work["pp_live"] += live_n
            work["pp_included"] += inc_n
        if d_att is not None:
            g = pixel_grad(out.detach(), tb)
            (ga,) = torch.autograd.grad(out, a, g)
            d_att.index_add_(0, rows[valid], ga[valid])
        img[py.reshape(-1), px.reshape(-1)] = out.detach().reshape(-1, 3)
    return img[:H, :W], d_att, work


def _blend_block(a, valid, px, py, tf32: bool, count: bool):
    """One block: a [B, L, 9] pairs' attributes in blend order, valid
    [B, L], pixel coordinates px, py [B, 256] → colours [B, 256, 3]."""
    mx, my = a[..., 0][:, None, :], a[..., 1][:, None, :]
    ca, cb, cc = a[..., 2][:, None, :], a[..., 3][:, None, :], a[..., 4][:, None, :]
    op = a[..., 8][:, None, :]
    dx = px[:, :, None] - mx
    dy = py[:, :, None] - my
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.clamp(op * torch.exp(power), max=ALPHA_CLAMP)
    elig = valid[:, None, :] & (alpha >= ALPHA_MIN) & (power <= 0)
    f = torch.where(elig, 1.0 - alpha, torch.ones_like(alpha))
    C = torch.cumprod(f, -1)
    before = C / f
    inc = elig & (C >= T_EPS)
    w = torch.where(inc, before * alpha, torch.zeros_like(alpha))
    out = mm(w, a[..., 5:8], tf32)
    live_n = inc_n = 0
    if count:
        live_n = int((elig & (before.detach() >= T_EPS)).sum())
        inc_n = int(inc.sum())
    return out, live_n, inc_n


def pixel_loss_grad(target_tiles: torch.Tensor, W: int, H: int, keep=None):
    """pixel_grad for loss = mean((img − target)²) over the image's H·W·3
    values, target_tiles [tiles_y·16, tiles_x·16, 3] (zero-padded); keep
    [tiles_y·16, tiles_x·16] bool, where given, is the pixels the mean
    runs over (all of the image's by default)."""
    tiles_x = target_tiles.shape[1] // TILE
    dev = target_tiles.device
    ly = torch.arange(TILE * TILE, device=dev) // TILE
    lx = torch.arange(TILE * TILE, device=dev) % TILE
    inside = torch.zeros(target_tiles.shape[:2], dtype=torch.bool, device=dev)
    inside[:H, :W] = True
    if keep is not None:
        inside &= keep
    denom = float(inside.sum()) * 3.0

    def grad(out, tb):
        px = ((tb % tiles_x) * TILE)[:, None] + lx[None, :]
        py = ((tb // tiles_x) * TILE)[:, None] + ly[None, :]
        m = inside[py, px][..., None]
        return torch.where(m, 2.0 * (out - target_tiles[py, px]) / denom, 0.0)

    return grad


def pad_tiles(img: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] → zero-padded to whole tiles."""
    H, W = img.shape[:2]
    out = torch.zeros((-(-H // TILE) * TILE, -(-W // TILE) * TILE, 3), device=img.device)
    out[:H, :W] = img
    return out


def render(p: dict, cam: dict, tf32: bool = False, count: bool = False):
    """The image [H, W, 3] of the parameters p at cam (no gradient), and
    with count=True the blend's work (composite's counts)."""
    with torch.no_grad():
        pr = project(p, cam, tf32)
        splat, tx, ty, _ = pairs(pr, cam["width"], cam["height"])
        tiles_x = -(-cam["width"] // TILE)
        img, _, work = composite(attributes(pr), splat, ty * tiles_x + tx, pr["depth"][splat],
                                 cam["width"], cam["height"], tf32, count=count)
    return (img, work) if count else img
