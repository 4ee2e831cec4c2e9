"""gsjax_torch.render.homesort's home gather: the kernel pair Q, Q'
(csrc/home_gather.cu) and its plain versions.

On the CPU: home_gather takes the plain versions (cat + index, and
reduce_home_rows), the same bits as those called directly, and launches
nothing; the launchers refuse CPU tensors. On the card (skipped without
one): Q bit-equal to cat([x, tail_x])[perm]; Q' against the segment sums
in float64, no farther from them than the plain version and the same
bits on two launches; a whole layout and its backward, kernel against
plain; the launch counts of a frame, an exact step, a legacy step and the
lazy trainer's resort and step."""

import numpy as np
import pytest
import torch

import gsjax_torch as gt
from gsjax_torch import kernels
from gsjax_torch.render import homesort as hs
from gsjax_torch.render.project import home_columns, home_splats, project

C = hs.PCOLS + 1  # a home row's floats


def _segments(rng, lens, n_trunc: int = 0, clip: int = 0, dev="cpu"):
    """The home gather's index inputs for splats with `lens` copy rows
    each, sorted by a random permutation of the N + F rows; the last
    n_trunc rows of the sort are cut (NH = N + F - n_trunc), the copy
    slots clipped at F = sum(lens) - clip. Returns (perm, inv, inv_tail,
    seg_base, f) on dev."""
    n = lens.shape[0]
    base = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    f = int(base[-1]) - clip
    perm_full = rng.permutation(n + f)
    inv = np.empty(n + f, np.int64)
    inv[perm_full] = np.arange(n + f)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (t(perm_full[:n + f - n_trunc]), t(inv[:n]), t(inv[n:]), t(np.minimum(base, f)), f)


def _rows(rng, r: int, dev="cpu"):
    """[r, C] float32 rows of lognormal magnitudes (a scale a row), last
    column zero as a home row's."""
    v = rng.normal(size=(r, C)) * rng.lognormal(0.0, 2.0, size=(r, 1))
    v[:, -1] = 0.0
    return torch.from_numpy(v.astype(np.float32)).to(dev)


@pytest.mark.parametrize("copies", [False, True])
def test_cpu_takes_the_plain_versions(copies):
    """F = 0 (the legacy layout) and F > 0 with truncated rows: the output
    is cat([x, tail_x])[perm] and the gradient reduce_home_rows of the
    cotangent, bit for bit, and no kernel counts a launch."""
    rng = np.random.default_rng(3)
    n = 500
    lens = rng.choice([0, 0, 0, 1, 2, 7, 40], size=n) if copies else np.zeros(n, np.int64)
    perm, inv, inv_tail, seg_base, f = _segments(rng, lens, n_trunc=37 if copies else 0)
    x = _rows(rng, n).requires_grad_()
    tail_x = x.detach()[torch.repeat_interleave(torch.arange(n), torch.from_numpy(lens))]
    kernels.reset_launches()
    out = hs.home_gather(x, tail_x, perm, inv, inv_tail, seg_base)
    assert torch.equal(out, torch.cat([x.detach(), tail_x])[perm])
    d = _rows(rng, perm.shape[0])
    out.backward(d)
    assert torch.equal(x.grad, hs.reduce_home_rows(d, f, inv, inv_tail, seg_base))
    assert (kernels.LAUNCHES["home_gather_fwd"], kernels.LAUNCHES["home_gather_bwd"]) == (0, 0)


def test_launchers_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only: they raise, and
    never fall back to the plain versions."""
    rng = np.random.default_rng(4)
    perm, inv, inv_tail, seg_base, _ = _segments(rng, np.array([0, 2, 1]))
    x = _rows(rng, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        hs.launch_home_gather(x, x[[1, 1, 2]], perm)
    with pytest.raises(ValueError, match="unsupported device"):
        hs.launch_reduce_home_rows(_rows(rng, perm.shape[0]), inv, inv_tail, seg_base)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the home gather kernels are CUDA only")
    return torch.device("cuda")


@pytest.mark.parametrize("case", ["legacy", "truncated", "bonsai", "garden"])
def test_forward_is_the_plain_gather_bit_for_bit_on_the_card(case):
    """Q against cat([x, tail_x])[perm]: F = 0; a truncated perm; the
    bonsai cell's shapes (N 1,200,000, F 2,400,256, NH 2,700,000) and
    garden's (N 5,000,000, F 4,194,304, NH 7,097,152). One launch a call,
    the same bits on two."""
    dev = _card()
    n, f, nh = {"legacy": (100_003, 0, 100_003), "truncated": (70_001, 50_000, 90_000),
                "bonsai": (1_200_000, 2_400_256, 2_700_000),
                "garden": (5_000_000, 4_194_304, 7_097_152)}[case]
    gen = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn((n, C), generator=gen, device=dev)
    tail_x = torch.randn((f, C), generator=gen, device=dev)
    perm = torch.randperm(n + f, generator=gen, device=dev)[:nh]
    kernels.reset_launches()
    got = hs.launch_home_gather(x, tail_x, perm)
    assert kernels.LAUNCHES["home_gather_fwd"] == 1
    assert torch.equal(got, torch.cat([x, tail_x])[perm])
    assert torch.equal(got, hs.launch_home_gather(x, tail_x, perm))


def _sums64(d, inv, inv_tail, seg_base):
    """The transpose of the home gather in float64: each splat's primary
    row plus its copy rows [seg_base[i], seg_base[i + 1]) (seg_base[0] =
    0), a row index >= NH giving zero."""
    nh = d.shape[0]
    d64 = torch.cat([d.double(), d.new_zeros((1, d.shape[1]), dtype=torch.float64)])
    out = d64[torch.clamp(inv, max=nh)]
    owner = torch.repeat_interleave(torch.arange(inv.shape[0], device=d.device),
                                    seg_base[1:] - seg_base[:-1])
    return out.index_add_(0, owner, d64[torch.clamp(inv_tail[:owner.shape[0]], max=nh)])


def _lens(rng, case: str):
    if case == "short":  # 0 and 1 copies, the common case
        return rng.choice([0, 0, 0, 1], size=200_000)
    if case == "long":  # 1,022 copies crossing the plain version's 1,024-row blocks
        lens = rng.choice([0, 0, 1, 3, 17, 300], size=20_000)
        lens[rng.choice(lens.shape[0], 60, replace=False)] = 1022
        return lens
    # test_homegather_precision.py's distribution: ~1M copy rows
    return np.minimum(rng.poisson(1_000_000 / 300_000, 300_000), 255)


@pytest.mark.parametrize("case", ["short", "long", "lognormal_1m"])
def test_backward_against_float64_on_the_card(case):
    """Q' against the float64 sums of each splat's primary row and copy
    rows (truncated rows, index >= NH, giving zero; the slots clipped at
    F): its worst |error| no larger than the plain version's on the same
    input, and the same bits on two launches; one launch a call."""
    dev = _card()
    rng = np.random.default_rng({"short": 10, "long": 11, "lognormal_1m": 12}[case])
    lens = _lens(rng, case)
    perm, inv, inv_tail, seg_base, f = _segments(rng, lens, n_trunc=int(lens.sum()) // 5,
                                                 clip=7, dev=dev)
    nh = perm.shape[0]
    d = _rows(rng, nh, dev)
    kernels.reset_launches()
    got = hs.launch_reduce_home_rows(d, inv, inv_tail, seg_base)
    assert kernels.LAUNCHES["home_gather_bwd"] == 1
    assert torch.equal(got, hs.launch_reduce_home_rows(d, inv, inv_tail, seg_base))
    plain = hs.reduce_home_rows(d, f, inv, inv_tail, seg_base)

    want = _sums64(d, inv, inv_tail, seg_base)
    err_k = float((got.double() - want).abs().max())
    err_p = float((plain.double() - want).abs().max())
    assert err_k <= err_p, (err_k, err_p)
    assert err_k <= 1e-5 * float(want.abs().max()), (err_k, float(want.abs().max()))


def _scene(rng, n: int, dev):
    """Gaussians in front of a 96×64 camera, a third of them large enough
    to be split into copies."""
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                      rng.uniform(2.0, 7.0, n)], axis=-1)
    ls = rng.uniform(-3.5, -1.5, (n, 3)) + np.where(rng.random((n, 1)) < 0.3, 1.5, 0.0)
    q = rng.normal(size=(n, 4))
    sh = rng.normal(size=(n, 1, 3)) * 0.5
    ol = rng.normal(size=n)
    return gt.Gaussians.from_numpy(means, ls, q, sh, ol, device=dev)


@pytest.mark.parametrize("legacy", [False, True])
def test_layout_and_backward_against_plain_on_the_card(legacy):
    """build_home_layout at a small scene: the home rows bit-equal to the
    plain gather of the projected rows and kernel A's copy rows; the
    gradient that reaches the projected rows within 1e-6 of its peak of
    the plain reduction (bit-equal with no copy row), no farther from
    float64."""
    dev = _card()
    rng = np.random.default_rng(5)
    cfg = gt.RenderConfig(backend="stream", chunk=32, fat_max_blocks=64, fat_cap=4096,
                          footprint_clamp=legacy)
    cam = gt.Camera.create(fx=80.0, fy=80.0, width=96, height=64, device=dev)
    with torch.no_grad():
        p = project(_scene(rng, 2000, dev), cam, cfg)
    x = home_columns(p).detach().clone().requires_grad_()
    px = home_splats(x, p.valid)
    tx, ty = cfg.tiles_x(cam.width), cfg.tiles_y(cam.height)
    if legacy:
        tail, f = x.new_zeros((0, C)), 0
        ph, layout = hs.build_home_layout(px, cam, cfg)
        inv = torch.empty_like(layout.perm)
        inv[layout.perm] = torch.arange(layout.perm.shape[0], device=dev)
        inv_tail, seg_base = inv[:0], torch.zeros(x.shape[0] + 1, dtype=torch.int64,
                                                  device=dev)
    else:
        tail = hs._exact_rows(px, tx, ty, cfg)[5]
        f = tail.shape[0]
        ph, layout, ex = hs.build_home_layout(px, cam, cfg, return_extras=True)
        inv, inv_tail, seg_base = ex["inv"], ex["inv_tail"], ex["seg_base"]
        assert int(layout.n_copies) > 100
    rows = home_columns(ph)
    assert torch.equal(rows, torch.cat([x.detach(), tail])[layout.perm])
    ct = _rows(rng, rows.shape[0], dev)
    (rows * ct).sum().backward()
    plain = hs.reduce_home_rows(ct, f, inv, inv_tail, seg_base)
    if legacy:
        assert torch.equal(x.grad, plain)
        return
    want = _sums64(ct, inv, inv_tail, seg_base)
    peak = float(want.abs().max())
    torch.testing.assert_close(x.grad, plain, rtol=0.0, atol=1e-6 * peak)
    assert float((x.grad.double() - want).abs().max()) <= float(
        (plain.double() - want).abs().max())


def test_launches_a_frame_a_step_and_the_lazy_trainer_on_the_card():
    """home_gather_fwd once a layout: a frame, an exact step, a legacy
    step, a resort; home_gather_bwd once an exact or legacy step, never
    in a no_grad frame or a lazy step."""
    dev = _card()
    rng = np.random.default_rng(6)
    cfg = gt.RenderConfig(backend="stream", chunk=32, fat_max_blocks=64, fat_cap=4096)
    cam = gt.Camera.create(fx=80.0, fy=80.0, width=96, height=64, device=dev)
    g = _scene(rng, 2000, dev)
    counts = lambda: (kernels.LAUNCHES["home_gather_fwd"], kernels.LAUNCHES["home_gather_bwd"])
    kernels.reset_launches()
    with torch.no_grad():
        target = gt.render(g, cam, cfg)
    assert counts() == (1, 0)
    for c in (cfg, gt.RenderConfig(backend="stream", chunk=32, footprint_clamp=True)):
        kernels.reset_launches()
        ((gt.render(g, cam, c) - target) ** 2).mean().backward()
        assert counts() == (1, 1)
    tr = gt.LazyTrainer(g, cfg, torch.optim.Adam(g.parameters(), lr=1e-3))
    kernels.reset_launches()
    tr.resort(cam)
    assert counts() == (1, 0)
    for _ in range(3):
        tr.step(target, cam)
    assert counts() == (1, 0)
