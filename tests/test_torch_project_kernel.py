"""gsjax_torch.render.project's kernel pair and its plain versions.

On the CPU: the hand-derived VJP (project_vjp_plain, the arithmetic the
backward kernel carries), the camera's gradient included, against
autograd of the composition, through the public route (project → the
autograd Function), in float64 so that a wrong term cannot hide under
rounding; the lazy table (project_table) against lazy_cols' old
composition; the routes (no grad, leaf grads, camera grads). On the card
(skipped without one): the kernels against their plain versions and the
launch counts."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import gsjax_torch as gt
from gsjax_torch import kernels
from gsjax_torch.core.gaussians import FIELDS
from gsjax_torch.render import project as P

W, H = 96, 64
EYE, AT = (0.3, -0.2, -0.5), (0.0, 0.1, 5.0)


def _scene(n: int, k: int, seed: int = 0) -> list:
    """Raw leaves (numpy float64) with every kind of row: in view, behind
    the camera, clamped at the fov limit in x and in y, zero scales (det
    ≤ 0 under lowpass 0), off screen, under alpha_min, a zero quaternion
    and, in row 0, a splat at the camera's position."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-2.5, 2.5, n), rng.uniform(-2.0, 2.0, n),
                      rng.uniform(-1.5, 9.0, n)], axis=-1)
    ls = rng.uniform(-4.0, -0.5, (n, 3))
    q = rng.normal(size=(n, 4))
    sh = rng.normal(size=(n, k, 3)) * 0.5
    ol = rng.normal(size=n) * 2.0
    means[0] = EYE
    means[1:4] = [[40.0, 0.0, 1.0], [0.0, -40.0, 1.0], [-40.0, 35.0, 2.0]]  # fov clamps
    means[4] = [0.0, 0.0, -1.0]  # behind
    ls[5] = -200.0  # exp underflows: a zero covariance
    ol[6:10] = -8.0  # opacity 3e-4 < 1/255
    q[10] = 0.0
    means[11] = [9.0, 0.5, 3.0]  # off screen, in front
    return [means, ls, q, sh, ol]


def _leaves(raw, dtype, dev="cpu", grad=True):
    out = [torch.tensor(a, dtype=dtype, device=dev) for a in raw]
    return [t.requires_grad_(grad) for t in out]


def _camera(dtype=torch.float32, dev="cpu", grad=False):
    c = gt.Camera.look_at(EYE, AT, fx=80.0, fy=80.0, width=W, height=H, device=dev)
    ts = [t.to(dtype).detach().requires_grad_(grad) for t in (c.position, c.quat, c.fx, c.fy)]
    return gt.Camera(*ts, width=W, height=H)


def _cotangents(p, seed=1):
    g = torch.Generator().manual_seed(seed)
    outs = (p.mean2d, p.depth, p.conic, p.rgb, p.opacity)
    return outs, [torch.randn(o.shape, generator=g, dtype=o.dtype).to(o.device) for o in outs]


def _through_the_function(t) -> bool:
    """Whether t is (a view of) the output of project's autograd Function."""
    fn = t.grad_fn
    while fn is not None and type(fn).__name__ != "_ProjectBackward":
        nxt = [f for f, _ in fn.next_functions if f is not None]
        fn = nxt[0] if len(nxt) == 1 else None
    return fn is not None


def _camera_of(camp, cam):
    """A camera whose view matrix, focal lengths, clamp limits and
    position are camera_params' values camp (what _terms reads)."""
    view = torch.cat([camp[:12].reshape(3, 4), camp.new_tensor([[0.0, 0.0, 0.0, 1.0]])])
    return types.SimpleNamespace(view_matrix=lambda: view, fx=camp[12], fy=camp[13],
                                 tan_half_fov=lambda: (camp[14] / 1.3, camp[15] / 1.3),
                                 position=camp[16:19], width=cam.width, height=cam.height)


def _cam_grads_of(cam):
    return (cam.position, cam.quat, cam.fx, cam.fy)


def _cam_grads(cam):
    return [t.grad for t in _cam_grads_of(cam)]


def _close(a, b, tol, skip_rows=()):
    """|a - b| ≤ tol·(peak of b over the rows not skipped), and within tol
    of their own size on the skipped rows (the at-camera row's gradient is
    ~1e12)."""
    keep = torch.ones(b.shape[0], dtype=torch.bool, device=b.device)
    keep[list(skip_rows)] = False
    peak = b[keep].abs().max()
    torch.testing.assert_close(a[keep], b[keep], rtol=0.0, atol=float(tol * peak))
    if skip_rows:
        torch.testing.assert_close(a[~keep], b[~keep], rtol=tol, atol=0.0)


@pytest.mark.parametrize("lowpass", [0.3, 0.0])
@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_vjp_matches_autograd_of_the_composition(degree, lowpass):
    """project's Function (forward: the composition; backward: the hand
    VJP) against autograd through project_plain, float64, every leaf; and
    the hand VJP's gradient of the camera block (camera_params' 19
    values) against autograd through project_plain of a camera made from
    that block."""
    cfg = gt.RenderConfig(lowpass=lowpass)
    raw = _scene(300, (1, 4, 9, 16)[degree], seed=degree)
    cam = _camera(torch.float64)
    ref_leaves = _leaves(raw, torch.float64)
    camp = P.camera_params(cam).detach().requires_grad_()
    p_ref = P.project_plain(*ref_leaves, _camera_of(camp, cam), cfg)
    outs, cts = _cotangents(p_ref)
    want = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cts)),
                               (*ref_leaves, camp))
    d_cam = P.project_vjp_plain(*_leaves(raw, torch.float64, grad=False), cam, cfg, *cts,
                                camera=True)[5]
    torch.testing.assert_close(d_cam, want[-1], rtol=1e-9, atol=0.0)

    g = gt.Gaussians(*_leaves(raw, torch.float64))
    p = P.project(g, cam, cfg)
    assert _through_the_function(p.mean2d) and P.home_columns(p) is p.home
    for f in ("mean2d", "depth", "conic", "radius", "rgb", "opacity", "valid"):
        assert torch.equal(getattr(p, f), getattr(p_ref, f)), f
    v = p.valid
    assert 100 < int(v.sum()) < 290 and not v[[0, 1, 2, 3, 4, 6, 7, 8, 9, 11]].any()
    outs, _ = _cotangents(p)
    sum((o * c).sum() for o, c in zip(outs, cts)).backward()
    for f, w in zip(FIELDS, want):
        _close(getattr(g, f).grad, w, 1e-9, skip_rows=(0,))
    if lowpass == 0.0:  # the zero covariance's det is 0: culled, no NaN
        assert not bool(p.valid[5]) and bool(torch.isfinite(g.log_scales.grad).all())


@pytest.mark.parametrize("degree", [0, 3])
def test_table_matches_the_lazy_cols_composition(degree):
    """project_table against lazy_cols' old composition (the where-masked
    columns of project_plain): the forward bit for bit in float32, the
    VJP in float64."""
    cfg = gt.RenderConfig()
    raw = _scene(257, (1, 16)[degree // 3], seed=7 + degree)
    cam = _camera()
    g32 = gt.Gaussians(*_leaves(raw, torch.float32))
    assert torch.equal(P.project_table(g32, cam, cfg),
                       P.table_plain(P.project_plain(*_leaves(raw, torch.float32), cam, cfg)))

    cam = _camera(torch.float64)
    ref_leaves = _leaves(raw, torch.float64)
    table = P.table_plain(P.project_plain(*ref_leaves, cam, cfg))
    ct = torch.randn(table.shape, generator=torch.Generator().manual_seed(3), dtype=table.dtype)
    want = torch.autograd.grad((table * ct).sum(), ref_leaves)
    g = gt.Gaussians(*_leaves(raw, torch.float64))
    (P.project_table(g, cam, cfg) * ct).sum().backward()
    for f, w in zip(FIELDS, want):
        _close(getattr(g, f).grad, w, 1e-9, skip_rows=(0,))


def test_routes_by_what_needs_a_gradient():
    """No grad: no graph. Leaves that need one: the Function. Only a
    camera tensor that needs one (pose refinement): the Function too, its
    camera gradients those of autograd through project_plain, through the
    table as through the fields: float64, within 1e-6 of each tensor's
    peak, as the camera's view matrix is float32 (camera.view_matrix) and
    the composition rounds each use's gradient of it there; no splat at
    the camera, whose ~1e12 gradient would swamp the position's. The
    layout takes project's buffer, and a rebuilt or replaced result's
    concatenation."""
    cfg = gt.RenderConfig()
    raw = _scene(200, 9, seed=3)
    g = gt.Gaussians(*_leaves(raw, torch.float32))
    with torch.no_grad():
        assert P.project(g, _camera(), cfg).mean2d.grad_fn is None
    p = P.project(g, _camera(), cfg)
    assert _through_the_function(p.conic) and _through_the_function(p.opacity)
    assert _through_the_function(P.project_table(g, _camera(), cfg))
    home = P.home_columns(p)
    assert home is p.home and home is p.mean2d._base and not home[:, 11].any()
    q = dataclasses.replace(p, conic=p.conic * 2.0)  # a pass's edit
    assert q.home is None and torch.equal(P.home_columns(q)[:, 3:6], q.conic)
    rows = P.ProjectedSplats(*(getattr(p, f.name)[:50] for f in dataclasses.fields(p)))
    assert rows.home is None and torch.equal(P.home_columns(rows), home[:50])

    raw[0][0] = (0.2, 0.1, 4.0)
    leaves = _leaves(raw, torch.float64, grad=False)
    g = gt.Gaussians(*leaves)
    for table in (False, True):
        cam_ref, cam = _camera(torch.float64, grad=True), _camera(torch.float64, grad=True)
        p_ref = P.project_plain(*leaves, cam_ref, cfg)
        outs = (P.table_plain(p_ref),) if table else _cotangents(p_ref)[0]
        cts = [torch.randn(o.shape, generator=torch.Generator().manual_seed(9 + i),
                           dtype=o.dtype) for i, o in enumerate(outs)]
        want = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, cts)),
                                   _cam_grads_of(cam_ref))
        if table:
            outs = (P.project_table(g, cam, cfg),)
        else:
            p = P.project(g, cam, cfg)
            outs = _cotangents(p)[0]
        assert _through_the_function(outs[0])
        sum((o * c).sum() for o, c in zip(outs, cts)).backward()
        for a, w in zip(_cam_grads(cam), want):
            torch.testing.assert_close(a, w, rtol=0.0, atol=float(1e-6 * w.abs().max()))


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the projection kernels are CUDA only")
    return torch.device("cuda")


@pytest.mark.parametrize("table", [False, True])
def test_kernels_match_their_plain_versions_on_the_card(table):
    """Every SH degree: valid and radius (the table's masked columns) row
    for row, the other columns within 1e-6 of each column's peak; the
    leaves' gradients, and the camera block's, within 1e-5 of each one's
    peak of the plain VJP computed in float64 (two float32 evaluations of
    the conic's inverse differ by more, each lies within ~8e-6 of
    float64), the leaves' the same bits with the camera's or without.
    One forward and one backward launch each."""
    dev = _card()
    cfg = gt.RenderConfig()
    for degree in range(4):
        raw = _scene(400, (1, 4, 9, 16)[degree], seed=20 + degree)
        cam = _camera(dev=dev)
        leaves = _leaves(raw, torch.float32, dev, grad=False)
        kernels.reset_launches()
        got = P.project_forward(leaves, cam, P.camera_params(cam), cfg, table)
        p = P.project_plain(*leaves, cam, cfg)  # the composition on the card
        ref = (P.table_plain(p),) if table else (P.home_columns(p), p.valid)
        assert kernels.LAUNCHES["project_fwd"] == 1
        if table:
            # the culled rows' constants and the row's mask bit for bit
            mask_cols = (0, 1, 2, 3, 4, 8)
            culled = ref[0][:, 8] == 0
            assert torch.equal(got[0][culled][:, list(mask_cols)], ref[0][culled][:, list(mask_cols)])
            for c in range(9):
                _close(got[0][:, c], ref[0][:, c], 1e-6)
        else:
            assert torch.equal(got[1], ref[1]) and torch.equal(got[0][:, 6], ref[0][:, 6])
            for c in range(12):
                _close(got[0][:, c], ref[0][:, c], 1e-6)

        n = leaves[0].shape[0]
        gen = torch.Generator().manual_seed(degree)
        if table:
            G = torch.randn((n, 9), generator=gen).to(dev)
            grads = (G[:, 0:2], None, G[:, 2:5], G[:, 5:8], G[:, 8])
        else:
            grads = tuple(torch.randn(s, generator=gen).to(dev)
                          for s in ((n, 2), (n,), (n, 3), (n, 3), (n,)))
        d = P.project_backward(leaves, cam, P.camera_params(cam), cfg, grads, masked=table)
        assert kernels.LAUNCHES["project_bwd"] == 1 and d[5] is None
        d_cam = P.project_backward(leaves, cam, P.camera_params(cam), cfg, grads, masked=table,
                                   camera=True)
        assert all(torch.equal(a, b) for a, b in zip(d[:5], d_cam[:5]))
        cam64 = _camera(torch.float64, dev)
        want = P.project_vjp_plain(*[t.double() for t in leaves], cam64, cfg,
                                   *[None if x is None else x.double() for x in grads],
                                   masked=table, camera=True)
        for a, b in zip(d[:5], want[:5]):
            _close(a.double(), b, 1e-5, skip_rows=(0,))
        torch.testing.assert_close(d_cam[5].double(), want[5], rtol=0.0,
                                   atol=float(1e-5 * want[5].abs().max()))


def test_launches_a_step_a_frame_and_a_pose_step_on_the_card():
    """project_fwd once a call, project_bwd once a backward, a camera that
    needs a gradient (a pose step) included, whose gradient reaches the
    camera's tensors."""
    dev = _card()
    cfg = gt.RenderConfig()
    raw = _scene(400, 16, seed=5)
    g = gt.Gaussians(*_leaves(raw, torch.float32, dev))
    cam = _camera(dev=dev)
    kernels.reset_launches()
    with torch.no_grad():
        P.project(g, cam, cfg)
    assert (kernels.LAUNCHES["project_fwd"], kernels.LAUNCHES["project_bwd"]) == (1, 0)
    P.project_table(g, cam, cfg).sum().backward()
    p = P.project(g, cam, cfg)
    (p.mean2d.sum() + p.rgb.sum()).backward()
    assert (kernels.LAUNCHES["project_fwd"], kernels.LAUNCHES["project_bwd"]) == (3, 2)
    kernels.reset_launches()
    cam = _camera(dev=dev, grad=True)
    p = P.project(g, cam, cfg)
    p.mean2d.sum().backward()
    assert (kernels.LAUNCHES["project_fwd"], kernels.LAUNCHES["project_bwd"]) == (1, 1)
    assert all(t is not None and bool(torch.isfinite(t).all()) for t in _cam_grads(cam))
