"""Per-splat 3D→2D projection — the PyTorch counterpart of
gsjax/render/project.py: Σ → screen-space conic via the perspective
Jacobian, frustum cull, footprint radius and SH color, all in float32.

On the card it is one kernel pair (csrc/project.cu), behind one
autograd Function: `project_forward` goes from the raw leaves to the
outputs in one pass (or, for the lazy step, to the blend's masked
attribute table, `project_table`), and `project_backward` is the
hand-derived VJP, which recomputes the forward from the leaves. The
camera enters as one [19] tensor (`camera_params`, made from the
camera's tensors by the composition's own ops); where it needs a
gradient (pose refinement), the backward gives its gradient too and
autograd carries that back to the camera's tensors. The forward writes
the fields as one [N, 12] buffer in the home layout's column order
(HOME_COLS) and `project` returns views of it and the buffer itself
(`ProjectedSplats.home`), which `home_columns` hands to the layout
without a copy. Their plain versions are the composition
(`project_plain`, gsjax's op for op) and the same VJP in PyTorch ops
(`project_vjp_plain`); CPU tensors take them, CUDA tensors launch the
kernels (there is no fallback). The SH degree comes from sh's shape."""

from __future__ import annotations

import dataclasses
import types

import torch

from gsjax_torch import kernels
from gsjax_torch.core.camera import Camera
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.core.gaussians import FIELDS, Gaussians, quat_to_rotmat
from gsjax_torch.render.sh import sh_basis_vjp, sh_color_terms

SH_KS = (1, 4, 9, 16)
#: the home table's columns (render/homesort.build_home_layout's row):
#: field → (first column, last + 1); column 11 is zero
HOME_COLS = {"mean2d": (0, 2), "depth": (2, 3), "conic": (3, 6), "radius": (6, 7),
             "rgb": (7, 10), "opacity": (10, 11)}


@dataclasses.dataclass(frozen=True)
class ProjectedSplats:
    """Screen-space splats.

    mean2d  [N, 2] pixel coords (pixel centers at integer coordinates)
    depth   [N]    camera-space z
    conic   [N, 3] (a, b, c): weight = exp(-0.5(a dx² + 2b dx dy + c dy²))
    radius  [N]    footprint radius in pixels (0 ⇒ culled)
    rgb     [N, 3] SH-evaluated color
    opacity [N]    activated opacity in [0, 1]
    valid   [N]    bool cull mask
    """

    mean2d: torch.Tensor
    depth: torch.Tensor
    conic: torch.Tensor
    radius: torch.Tensor
    rgb: torch.Tensor
    opacity: torch.Tensor
    valid: torch.Tensor
    #: the projection kernel's [N, 12] buffer (HOME_COLS) whose views the
    #: fields are, else None. Not a dataclass field: `dataclasses.replace`
    #: and every rebuild from the fields drop it.
    home = None


def project(g: Gaussians, cam: Camera, cfg: RenderConfig = RenderConfig()
            ) -> ProjectedSplats:
    """g's splats under cam, differentiable in g's leaves and in the
    camera's tensors. The fields are views of one home-table buffer
    (HOME_COLS), which the result carries as `home`."""
    home, valid = _apply(g, cam, cfg, table=False)
    p = home_splats(home, valid)
    object.__setattr__(p, "home", home)
    return p


def home_splats(rows: torch.Tensor, valid: torch.Tensor) -> ProjectedSplats:
    """The fields as views of home-table rows [N, 12] (HOME_COLS)."""
    return ProjectedSplats(**{f: rows[:, lo] if hi - lo == 1 else rows[:, lo:hi]
                              for f, (lo, hi) in HOME_COLS.items()}, valid=valid)


def home_columns(p: ProjectedSplats) -> torch.Tensor:
    """p's fields as the home table's rows [N, 12] (HOME_COLS; column 11
    zero): the buffer project made (no copy, and the layout's gradient
    reaches the projection whole), else their concatenation (a pass
    replaced a field, or the rows were rebuilt)."""
    if p.home is not None:
        return p.home
    cols = [getattr(p, f) for f in HOME_COLS]
    return torch.cat([c if c.dim() == 2 else c[:, None] for c in cols]
                     + [torch.zeros_like(p.depth)[:, None]], dim=-1)


def project_table(g: Gaussians, cam: Camera, cfg: RenderConfig = RenderConfig()
                  ) -> torch.Tensor:
    """The blend's attribute table [N, 9] (composite.att_table's columns:
    mean2d, conic, rgb, opacity) of g under cam, a row the projection
    culls masked to opacity 0, mean 0 and conic (1, 0, 1): it draws
    nothing. The means are absolute, as kernel C reads them."""
    return _apply(g, cam, cfg, table=True)[0]


def _apply(g: Gaussians, cam: Camera, cfg: RenderConfig, table: bool):
    leaves = tuple(getattr(g, f) for f in FIELDS)
    camp = camera_params(cam)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*leaves, camp)):
        out = _Project.apply(*leaves, camp, cam, cfg, table)
        return (out,) if table else out
    return project_forward(leaves, cam, camp, cfg, table)


#: the output gradients project_backward takes, as columns of the home
#: table's gradient (radius and column 11 take none) and of the lazy table's
_GRAD_COLS = {False: tuple(HOME_COLS[f] for f in ("mean2d", "depth", "conic", "rgb",
                                                 "opacity")),
              True: ((0, 2), None, (2, 5), (5, 8), (8, 9))}


class _Project(torch.autograd.Function):
    @staticmethod
    def forward(ctx, means, log_scales, quats, sh, opacity_logits, camp, cam, cfg, table):
        leaves = (means, log_scales, quats, sh, opacity_logits)
        out = project_forward(leaves, cam, camp, cfg, table)
        ctx.save_for_backward(*leaves, camp)
        ctx.args = (cam, cfg, table)
        ctx.set_materialize_grads(False)
        if table:
            return out[0]
        ctx.mark_non_differentiable(out[1])  # valid
        return out

    @staticmethod
    def backward(ctx, g, _=None):
        cam, cfg, table = ctx.args
        none = (None,) * 9
        if g is None:
            return none
        gs = tuple(None if c is None else g[:, c[0]] if c[1] - c[0] == 1 else g[:, c[0]:c[1]]
                   for c in _GRAD_COLS[table])
        *leaves, camp = ctx.saved_tensors
        d = project_backward(leaves, cam, camp, cfg, gs, masked=table,
                             camera=ctx.needs_input_grad[5])
        return tuple(di if need else None for di, need in zip(d, ctx.needs_input_grad)) + none[6:]


# --------------------------------------------------------------------------
# the plain versions
# --------------------------------------------------------------------------


def _terms(means, log_scales, quats, sh, opacity_logits, cam: Camera, cfg: RenderConfig):
    """Every intermediate of the composition (gsjax's projection op for
    op), for project_plain and the VJP."""
    t = types.SimpleNamespace()
    view = cam.view_matrix()
    t.W = W = view[:3, :3]
    t.t_cam = torch.sum(means[:, None, :] * W[None, :, :], dim=-1) + view[:3, 3]
    z = t.t_cam[:, 2]
    t.in_front = z > cfg.near_cull

    tan_fovx, tan_fovy = cam.tan_half_fov()
    t.limx, t.limy = 1.3 * tan_fovx, 1.3 * tan_fovy
    t.zc = zc = torch.where(t.in_front, z, torch.ones_like(z))
    t.ux, t.uy = t.t_cam[:, 0] / zc, t.t_cam[:, 1] / zc
    t.uxc = torch.clamp(t.ux, -t.limx, t.limx)
    t.uyc = torch.clamp(t.uy, -t.limy, t.limy)
    t.tx, t.ty = t.uxc * zc, t.uyc * zc

    fx, fy = cam.fx, cam.fy
    t.inv_z = inv_z = 1.0 / zc
    t.inv_z2 = inv_z2 = inv_z * inv_z
    t.j00 = j00 = fx * inv_z
    t.j02 = j02 = -fx * t.tx * inv_z2
    t.j11 = j11 = fy * inv_z
    t.j12 = j12 = -fy * t.ty * inv_z2

    # T = J @ W (2×3); cov2d = T Σ Tᵀ with Σ = M Mᵀ, M = R·diag(s)
    t.T0 = j00[:, None] * W[0][None, :] + j02[:, None] * W[2][None, :]
    t.T1 = j11[:, None] * W[1][None, :] + j12[:, None] * W[2][None, :]
    # smoothed norm: the max-clamped norm's gradient at q = 0 is NaN
    t.qden = torch.sqrt(torch.sum(quats * quats, dim=-1, keepdim=True) + 1e-24)
    t.qn = quats / t.qden
    t.R = quat_to_rotmat(t.qn)
    t.scales = torch.exp(log_scales)
    t.M = t.R * t.scales[:, None, :]
    t.a0 = torch.sum(t.T0[:, :, None] * t.M, dim=1)
    t.a1 = torch.sum(t.T1[:, :, None] * t.M, dim=1)
    t.c00 = torch.sum(t.a0 * t.a0, dim=-1) + cfg.lowpass
    t.c01 = torch.sum(t.a0 * t.a1, dim=-1)
    t.c11 = torch.sum(t.a1 * t.a1, dim=-1) + cfg.lowpass

    det = t.c00 * t.c11 - t.c01 * t.c01
    t.det_ok = det > 0.0
    det_safe = torch.where(t.det_ok, det, torch.ones_like(det))
    t.inv_det = 1.0 / det_safe
    t.conic = torch.stack([t.c11 * t.inv_det, -t.c01 * t.inv_det, t.c00 * t.inv_det], dim=-1)

    mid = 0.5 * (t.c00 + t.c11)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det_safe, min=0.1))
    t.radius = torch.ceil(cfg.radius_sigma * torch.sqrt(lam1))

    cx = (cam.width - 1.0) * 0.5
    cy = (cam.height - 1.0) * 0.5
    t.mean2d = torch.stack(
        [fx * t.t_cam[:, 0] * inv_z + cx, fy * t.t_cam[:, 1] * inv_z + cy], dim=-1
    )
    on_screen = (
        (t.mean2d[:, 0] + t.radius >= 0)
        & (t.mean2d[:, 0] - t.radius < cam.width)
        & (t.mean2d[:, 1] + t.radius >= 0)
        & (t.mean2d[:, 1] - t.radius < cam.height)
    )

    t.opacity = torch.sigmoid(opacity_logits)
    dirs = means - cam.position
    # smoothed norm: a splat at the camera position must not give 0/0
    t.dden = torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True) + 1e-24)
    t.dirs = dirs / t.dden
    t.basis, t.raw = sh_color_terms(sh, t.dirs)  # eval_sh before its clamp
    t.rgb = torch.clamp(t.raw, min=0.0)

    t.valid = t.in_front & t.det_ok & on_screen & (t.opacity >= cfg.alpha_min)
    return t


def project_plain(means, log_scales, quats, sh, opacity_logits, cam: Camera,
                  cfg: RenderConfig = RenderConfig()) -> ProjectedSplats:
    """Plain version of the forward kernel: the composition, differentiable
    by autograd in the leaves and the camera's tensors."""
    t = _terms(means, log_scales, quats, sh, opacity_logits, cam, cfg)
    return ProjectedSplats(
        mean2d=t.mean2d,
        depth=t.t_cam[:, 2],
        conic=t.conic,
        radius=torch.where(t.valid, t.radius, torch.zeros_like(t.radius)),
        rgb=t.rgb,
        opacity=t.opacity,
        valid=t.valid,
    )


def table_plain(p: ProjectedSplats) -> torch.Tensor:
    """project_table's columns from the projected splats."""
    val = p.valid
    cols = (torch.where(val, p.mean2d[:, 0], 0.0), torch.where(val, p.mean2d[:, 1], 0.0),
            torch.where(val, p.conic[:, 0], 1.0), torch.where(val, p.conic[:, 1], 0.0),
            torch.where(val, p.conic[:, 2], 1.0), p.rgb[:, 0], p.rgb[:, 1], p.rgb[:, 2],
            torch.where(val, p.opacity, 0.0))
    return torch.stack(cols, dim=-1)


def _rotmat_vjp(qn, g_R):
    """The VJP of quat_to_rotmat at unit quats qn [N, 4] for g_R [N, 3, 3]."""
    w, x, y, z = qn.unbind(-1)
    g00, g01, g02, g10, g11, g12, g20, g21, g22 = g_R.reshape(-1, 9).unbind(-1)
    gw = 2.0 * (-z * g01 + y * g02 + z * g10 - x * g12 - y * g20 + x * g21)
    gx = 2.0 * (y * g01 + z * g02 + y * g10 - 2.0 * x * g11 - w * g12 + z * g20
                + w * g21 - 2.0 * x * g22)
    gy = 2.0 * (-2.0 * y * g00 + x * g01 + w * g02 + x * g10 + z * g12 - w * g20
                + z * g21 - 2.0 * y * g22)
    gz = 2.0 * (-2.0 * z * g00 - w * g01 + x * g02 + w * g10 - 2.0 * z * g11
                + y * g12 + x * g20 + y * g21)
    return torch.stack([gw, gx, gy, gz], dim=-1)


def project_vjp_plain(means, log_scales, quats, sh, opacity_logits, cam: Camera,
                      cfg: RenderConfig, g_mean2d=None, g_depth=None, g_conic=None,
                      g_rgb=None, g_opacity=None, masked: bool = False, camera: bool = False):
    """Plain version of the backward kernel: the hand-derived VJP of
    project_plain in the leaves (d_means, d_log_scales, d_quats, d_sh,
    d_opacity_logits) and, where camera is set, in camera_params' [19]
    values (else None), for the outputs' gradients (None: zero). masked:
    the gradients are the table's, so a culled row's mean2d, conic and
    opacity take none (its columns were constants). The forward is
    recomputed from the leaves; every cull and clamp decision is the
    forward's, and a where's unselected branch gets no gradient (a clamp
    passes it to the bound the value lies beyond, as torch.clamp does)."""
    with torch.no_grad():
        t = _terms(means, log_scales, quats, sh, opacity_logits, cam, cfg)
        n = means.shape[0]
        zero = means.new_zeros(n)
        keep = (lambda x: torch.where(t.valid, x, 0.0)) if masked else (lambda x: x)
        gm = [keep(zero if g_mean2d is None else g_mean2d[:, j]) for j in range(2)]
        gk = [keep(zero if g_conic is None else g_conic[:, j]) for j in range(3)]
        g_op = keep(zero if g_opacity is None else g_opacity)
        g_rgb = means.new_zeros((n, 3)) if g_rgb is None else g_rgb
        g_depth = zero if g_depth is None else g_depth
        W, fx, fy = t.W, cam.fx, cam.fy

        d_ol = g_op * (1.0 - t.opacity) * t.opacity
        # rgb = max(Σ_k B_k sh_k + 0.5, 0); dirs = d / |d|
        g_raw = torch.where(t.raw >= 0.0, g_rgb, 0.0)
        d_sh = t.basis[:, :, None] * g_raw[:, None, :]
        g_dir = sh_basis_vjp(t.dirs, torch.sum(sh * g_raw[:, None, :], dim=-1))
        g_d = (g_dir - t.dirs * torch.sum(t.dirs * g_dir, dim=-1, keepdim=True)) / t.dden

        # mean2d = (f·tc) / z + c; depth = tc_z
        tc0, tc1 = t.t_cam[:, 0], t.t_cam[:, 1]
        g_inv_z = gm[0] * (fx * tc0) + gm[1] * (fy * tc1)
        # conic = (c11, -c01, c00) / det
        g_c00, g_c11, g_c01 = gk[2] * t.inv_det, gk[0] * t.inv_det, -gk[1] * t.inv_det
        g_inv = gk[0] * t.c11 - gk[1] * t.c01 + gk[2] * t.c00
        g_det = torch.where(t.det_ok, -g_inv * t.inv_det * t.inv_det, 0.0)
        g_c00 = g_c00 + g_det * t.c11
        g_c11 = g_c11 + g_det * t.c00
        g_c01 = g_c01 - 2.0 * g_det * t.c01
        # c = (a0·a0 + lp, a0·a1, a1·a1 + lp); a = Mᵀ T; M = R·diag(s)
        g_a0 = 2.0 * g_c00[:, None] * t.a0 + g_c01[:, None] * t.a1
        g_a1 = 2.0 * g_c11[:, None] * t.a1 + g_c01[:, None] * t.a0
        g_T0 = torch.sum(t.M * g_a0[:, None, :], dim=-1)
        g_T1 = torch.sum(t.M * g_a1[:, None, :], dim=-1)
        g_M = t.T0[:, :, None] * g_a0[:, None, :] + t.T1[:, :, None] * g_a1[:, None, :]
        d_ls = torch.sum(g_M * t.R, dim=1) * t.scales
        g_qn = _rotmat_vjp(t.qn, g_M * t.scales[:, None, :])
        d_q = (g_qn - t.qn * torch.sum(t.qn * g_qn, dim=-1, keepdim=True)) / t.qden

        # T0 = j00 W0 + j02 W2, T1 = j11 W1 + j12 W2, the clamped Jacobian
        g_j00, g_j02 = torch.sum(g_T0 * W[0], -1), torch.sum(g_T0 * W[2], -1)
        g_j11, g_j12 = torch.sum(g_T1 * W[1], -1), torch.sum(g_T1 * W[2], -1)
        g_inv_z = g_inv_z + g_j00 * fx + g_j11 * fy
        g_inv_z2 = -(g_j02 * fx * t.tx + g_j12 * fy * t.ty)
        g_tx, g_ty = -g_j02 * fx * t.inv_z2, -g_j12 * fy * t.inv_z2
        g_inv_z = g_inv_z + 2.0 * t.inv_z * g_inv_z2
        # inv_z = 1 / zc; tx = clamp(tc0 / zc)·zc (torch.clamp passes its bounds)
        g_zc = -g_inv_z * t.inv_z * t.inv_z + g_tx * t.uxc + g_ty * t.uyc
        g_ux = torch.where((t.ux >= -t.limx) & (t.ux <= t.limx), g_tx * t.zc, 0.0)
        g_uy = torch.where((t.uy >= -t.limy) & (t.uy <= t.limy), g_ty * t.zc, 0.0)
        g_zc = g_zc - (g_ux * tc0 + g_uy * tc1) / (t.zc * t.zc)
        g_tc = torch.stack([gm[0] * fx * t.inv_z + g_ux / t.zc,
                            gm[1] * fy * t.inv_z + g_uy / t.zc,
                            g_depth + torch.where(t.in_front, g_zc, 0.0)], dim=-1)
        # tc = W m + t
        d_means = torch.sum(g_tc[:, :, None] * W[None, :, :], dim=1) + g_d
        d_cam = None
        if camera:  # camera_params' order: W | t rows, fx, fy, the limits, the position
            g_W = torch.sum(g_tc[:, :, None] * means[:, None, :], dim=0)
            g_W = g_W + torch.stack([torch.sum(g_T0 * t.j00[:, None], 0),
                                     torch.sum(g_T1 * t.j11[:, None], 0),
                                     torch.sum(g_T0 * t.j02[:, None] + g_T1 * t.j12[:, None], 0)])
            g_uxc, g_uyc = g_tx * t.zc, g_ty * t.zc
            beyond = lambda u, lim, g: torch.where(u > lim, g, 0.0) - torch.where(u < -lim, g, 0.0)
            d_cam = torch.cat([
                torch.cat([g_W, torch.sum(g_tc, 0)[:, None]], dim=1).reshape(12),
                torch.stack([torch.sum(g_j00 * t.inv_z - g_j02 * t.tx * t.inv_z2
                                       + gm[0] * tc0 * t.inv_z),
                             torch.sum(g_j11 * t.inv_z - g_j12 * t.ty * t.inv_z2
                                       + gm[1] * tc1 * t.inv_z),
                             torch.sum(beyond(t.ux, t.limx, g_uxc)),
                             torch.sum(beyond(t.uy, t.limy, g_uyc))]),
                -torch.sum(g_d, 0)])
    return d_means, d_ls, d_q, d_sh, d_ol, d_cam


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------


def camera_params(cam: Camera) -> torch.Tensor:
    """The camera as the kernels read it, [19] f32 on its device, each
    value made by the composition's own ops: the view matrix's rows 0-2,
    fx, fy, the clamp limits 1.3·tan(fov/2), the position."""
    view = cam.view_matrix()
    tan_fovx, tan_fovy = cam.tan_half_fov()
    return torch.cat([view[:3].reshape(12), cam.fx.reshape(1), cam.fy.reshape(1),
                      (1.3 * tan_fovx).reshape(1), (1.3 * tan_fovy).reshape(1),
                      cam.position.reshape(3)])


def _consts(cam: Camera, cfg: RenderConfig):
    return (cfg.near_cull, cfg.lowpass, cfg.radius_sigma, cfg.alpha_min,
            (cam.width - 1.0) * 0.5, (cam.height - 1.0) * 0.5, float(cam.width),
            float(cam.height))


def _kernel_leaves(leaves, camp):
    """The leaves as the kernels take them (float32, contiguous, on one
    CUDA device), or ValueError."""
    means, log_scales, quats, sh, ol = leaves
    n = means.shape[0]
    shapes_ok = (means.shape == (n, 3) and log_scales.shape == (n, 3)
                 and quats.shape == (n, 4) and sh.dim() == 3 and sh.shape[0] == n
                 and sh.shape[1] in SH_KS and sh.shape[2] == 3 and ol.shape == (n,)
                 and camp is not None and camp.shape == (19,))
    if not shapes_ok:
        raise ValueError("project: unexpected leaf shapes "
                         f"{[tuple(x.shape) for x in leaves]} (sh [N, 1|4|9|16, 3])")
    every = (*leaves, camp)
    if any(x.dtype != torch.float32 or x.device != means.device for x in every):
        raise ValueError("project: the leaves and the camera must be float32 on one device")
    return tuple(x.contiguous() for x in leaves), camp.contiguous()


def project_forward(leaves, cam: Camera, camp, cfg: RenderConfig, table: bool):
    """The forward kernel (csrc/project.cu, project_fwd_kernel): (the home
    table [N, 12] of the fields in HOME_COLS' order, valid [N] bool), or
    (table) the 1-tuple of the [N, 9] table. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if leaves[0].device.type == "cpu":
        p = project_plain(*leaves, cam, cfg)
        return (table_plain(p),) if table else (home_columns(p), p.valid)
    leaves, camp = _kernel_leaves(leaves, camp)
    n, k, dev = leaves[0].shape[0], leaves[3].shape[1], leaves[0].device
    if table:
        out = (torch.empty((n, 9), dtype=torch.float32, device=dev),)
        ptrs = (None, None, out[0].data_ptr())
    else:
        out = (torch.empty((n, 12), dtype=torch.float32, device=dev),
               torch.empty(n, dtype=torch.bool, device=dev))
        ptrs = (out[0].data_ptr(), out[1].data_ptr(), None)
    if n:
        err = kernels.lib().gsjax_project_forward(
            *(x.data_ptr() for x in leaves), camp.data_ptr(), n, k, *_consts(cam, cfg),
            *ptrs, kernels.stream_ptr(leaves[0]))
        kernels.check(err, "project_forward")
        kernels.LAUNCHES["project_fwd"] += 1
    return out


def project_backward(leaves, cam: Camera, camp, cfg: RenderConfig, grads, masked: bool,
                     camera: bool = False):
    """The backward kernel (csrc/project.cu, project_bwd_kernel, and
    cam_reduce_kernel where camera is set): the leaves' gradients and the
    camera block's (or None) for grads = (g_mean2d, g_depth, g_conic,
    g_rgb, g_opacity), each None (zero) or a view with one row per splat.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if leaves[0].device.type == "cpu":
        return project_vjp_plain(*leaves, cam, cfg, *grads, masked=masked, camera=camera)
    leaves, camp = _kernel_leaves(leaves, camp)
    n, k = leaves[0].shape[0], leaves[3].shape[1]
    gargs, held = [], []  # held: the views the launch reads stay alive
    for g, w in zip(grads, (2, 1, 3, 3, 1)):
        if g is None:
            gargs += [None, 0]
            continue
        if g.dtype != torch.float32 or g.device != leaves[0].device or g.shape[0] != n:
            raise ValueError(f"project_backward: a gradient {tuple(g.shape)} {g.dtype}")
        g = g.reshape(n, w)
        if w > 1 and g.stride(1) != 1:
            g = g.contiguous()
        held.append(g)
        gargs += [g.data_ptr(), g.stride(0)]
    d = tuple(torch.empty_like(x) for x in leaves)
    d_cam = torch.zeros_like(camp) if camera else None
    if n:
        part = camp.new_empty(kernels.lib().gsjax_project_cam_scratch(n)) if camera else None
        err = kernels.lib().gsjax_project_backward(
            *(x.data_ptr() for x in leaves), camp.data_ptr(), n, k, *_consts(cam, cfg),
            *gargs, int(masked), *(x.data_ptr() for x in d),
            *((part.data_ptr(), d_cam.data_ptr()) if camera else (None, None)),
            kernels.stream_ptr(leaves[0]))
        kernels.check(err, "project_backward")
        kernels.LAUNCHES["project_bwd"] += 1
    return (*d, d_cam)
