"""Lazy frame plans: the home layout reused across training steps, with
parameters and optimizer state kept in home order between resorts — the
PyTorch counterpart of gsjax/render/lazy.py.

A per-frame-exact step (train.make_step_fn) rebuilds every step a layout
that barely changes between steps: the (home tile, depth) sort, the fat
splats' copy rows (kernel A), the pair expansion and its sort (kernel B),
and in the backward the home gather's inverse and copy-segment sums.
Here:

  * `build_frame_plan` runs that prologue once (a "resort") at the
    current parameters and camera and keeps what depends on the order:
    each home row's source splat, the inverse structure, the home tiles
    and the sorted pair stream (FramePlan);
  * between resorts the parameters AND the optimizer's state live in
    home order (`extract_home`): a lazy step is project(home rows) →
    attribute table → kernel C → loss → kernel D (and its class sum) →
    the optimizer on the home rows. No sort and no row gather, forward
    or backward: the gradients arrive in home order and stay there;
  * a fat splat's copy rows carry parameter copies of their own and
    train apart between resorts; at the next resort `fold_back` reduces
    each row's DELTA onto its splat (the copy-segment sums of the home
    gather's VJP), averaged over the splat's live rows by default.

What is stale between resorts: pair membership and order, each row's
window and cull, the tiles' segments. What is fresh every step: every
attribute the blend reads (the current parameters projected under the
current camera); a row the fresh projection culls is masked to zero
opacity. The first step after a resort renders what the exact path
renders: a copy row projects its parent's parameters, which is what
kernel A copies into the exact path's tail rows.

The TPU's pid windows, band DMA table and bf16 split table (`pidwin`,
`tile_of`, `cbase`, `blktab`) feed only the TPU kernels and have no
counterpart; kernels C and D read the plan's pair stream and the fresh
f32 attribute table directly. `build_band_plan` is a band's resort on
the tile-sharded path (band_prefilter, home layout, slice_band_rows, the
band's pairs): its pidx maps the band's home rows to the global splats,
so extract_home and lazy_render take it unchanged; its inverse structure
is the band's own (a fold back across bands is not defined, as in the
reference).
"""

from __future__ import annotations

import dataclasses

import torch

from gsjax_torch import trace
from gsjax_torch.core.camera import Camera
from gsjax_torch.core.config import RenderConfig
from gsjax_torch.core.gaussians import FIELDS, Gaussians
from gsjax_torch.render.binning import build_band_bins, build_tile_bins
from gsjax_torch.render.composite import assemble_band, clipped_pair_stream
from gsjax_torch.render.homesort import build_home_layout, reduce_copy_segments
from gsjax_torch.render.pipeline import _project_any
from gsjax_torch.render.project import project_table
from gsjax_torch.render.stream import blend_stream

#: the widest column group the extract and fold passes pack at once: the
#: peak memory of either is one group's [NH, ≤ 64] temporaries
GROUP_COLS = 64


@dataclasses.dataclass(frozen=True)
class FramePlan:
    """Everything order-dependent about one frame, captured at a resort.

    pidx [NH] i64: the source splat of each home row (a primary row its
    own splat, a copy row its fat parent, a dead row N: the zero pad row
    of extract_home). inv [N] / inv_tail [F] / seg_base [N+1]: the
    inverse structure fold_back reduces the deltas through (that of the
    home gather's VJP). home_x / home_y [NH] i32: each row's home tile.
    pid [S] i32 / starts [T+1] i32: the sorted pair stream kernels C and
    D read. ovf: the overflow counters of the resort (the plan's stream
    is fixed, so they are every lazy step's too), the reference's keys."""

    pidx: torch.Tensor
    inv: torch.Tensor
    inv_tail: torch.Tensor
    seg_base: torch.Tensor
    home_x: torch.Tensor
    home_y: torch.Tensor
    pid: torch.Tensor
    starts: torch.Tensor
    ovf: dict
    ty0: int
    tiles_x: int
    band_rows: int
    n: int

    @property
    def nh(self) -> int:
        return self.pidx.shape[0]


def build_frame_plan(g: Gaussians, cam: Camera, cfg: RenderConfig) -> FramePlan:
    """One resort: project → home layout (kernel A) → pair expansion
    (kernel B) and its sort, at g's current parameters and this camera,
    frozen into a FramePlan. The stream backend's exact footprints are
    required (cfg.backend is not read: only kernels C and D consume the
    plan)."""
    if cfg.tile_span != 3:
        raise ValueError("frame plans require tile_span == 3 (stream backend)")
    if cfg.footprint_clamp:
        raise ValueError("frame plans require exact footprints (footprint_clamp=False)")
    cam = cam.to(g.device)
    with torch.no_grad():
        p = _project_any(g, cam, cfg)
        ph, layout, extras = build_home_layout(p, cam, cfg, return_extras=True)
        bins = build_tile_bins(ph, cam, cfg, anchor="home", layout=layout)
        pid, starts, n_dropped = clipped_pair_stream(bins, cfg)
    n = p.depth.shape[0]
    zero = torch.zeros((), dtype=torch.int32, device=g.device)
    return FramePlan(
        # dead rows (culled at the resort, or copy slots no splat fills)
        # read the zero pad row and get no pairs, so they render nothing,
        # receive no gradient and fold back nothing
        pidx=torch.where(ph.valid, extras["src_sorted"], n),
        inv=extras["inv"],
        inv_tail=extras["inv_tail"],
        seg_base=extras["seg_base"],
        home_x=layout.home_x,
        home_y=layout.home_y,
        pid=pid,
        starts=starts,
        ovf={
            "n_pair_overflow": (n_dropped + bins.n_repack_overflow).to(torch.int32),
            "n_band_overflow": zero,  # no band scratch in the port
            "n_fat_overflow": layout.n_fat_overflow,
            "n_tile_overflow": zero,
            "n_pairs": bins.n_pairs,
        },
        ty0=bins.ty0,
        tiles_x=bins.tiles_x,
        band_rows=bins.band_rows,
        n=n,
    )


def build_band_plan(g: Gaussians, cam: Camera, cfg: RenderConfig, ty0: int,
                    band_rows: int, rows_live: int | None = None) -> FramePlan:
    """A band's resort for the tile-sharded lazy path: the chain of
    binning.build_band_bins, which _render_band runs (band_prefilter →
    home layout → slice_band_rows → the band's pairs, kernels A and B),
    always prefiltered and sliced, frozen into a
    FramePlan of the band [ty0, ty0 + band_rows), content bounded to
    [ty0, ty0 + rows_live) (default band_rows). pidx maps each home row
    to its GLOBAL splat (the prefilter's idx composed with the band's
    source index), so extract_home and lazy_render take the plan as they
    take a frame's; inv / inv_tail / seg_base are the prefiltered scene's,
    rebased to the band's window (≥ NH: outside it). ovf counts the
    prefilter's and the slice's drops in n_band_overflow."""
    if cfg.tile_span != 3 or cfg.footprint_clamp:
        raise ValueError("band plans require the exact stream path")
    cam = cam.to(g.device)
    tiles_x = cfg.tiles_x(cam.width)
    with torch.no_grad():
        p = _project_any(g, cam, cfg)
        n = p.depth.shape[0]
        ph, layout, bins, n_pref, n_sliced, extras = build_band_bins(
            p, cam, cfg, ty0, band_rows, rows_live, restrict=True, return_extras=True)
        pid, starts, n_dropped = clipped_pair_stream(bins, cfg)
        gidx, start_c = extras["gidx"], extras["start"]
        gpad = torch.cat([gidx, gidx.new_full((1,), n)])
        gsrc = gpad[torch.clamp(extras["src_band"], max=gpad.shape[0] - 1)]
        cap_h = ph.depth.shape[0]
        rebase = lambda inv: torch.where((inv >= start_c) & (inv < start_c + cap_h),
                                         inv - start_c, cap_h)
    zero = torch.zeros((), dtype=torch.int32, device=g.device)
    return FramePlan(
        pidx=torch.where(ph.valid, gsrc, n),
        inv=rebase(extras["inv"]),
        inv_tail=rebase(extras["inv_tail"]),
        seg_base=extras["seg_base"],
        home_x=layout.home_x,
        home_y=layout.home_y,
        pid=pid,
        starts=starts,
        ovf={
            "n_pair_overflow": (n_dropped + bins.n_repack_overflow).to(torch.int32),
            "n_band_overflow": (n_pref + n_sliced).to(torch.int32),
            "n_fat_overflow": layout.n_fat_overflow,
            "n_tile_overflow": zero,
            "n_pairs": bins.n_pairs,
        },
        ty0=ty0,
        tiles_x=tiles_x,
        band_rows=band_rows,
        n=n,
    )


# --------------------------------------------------------------------------
# home-resident state
# --------------------------------------------------------------------------


def _per_splat(t, n: int) -> bool:
    """A tensor extract_home and fold_back re-index: float32, one row per
    splat. Others (an optimizer's step count) pass through."""
    return (isinstance(t, torch.Tensor) and t.dim() >= 1 and t.shape[0] == n
            and t.dtype == torch.float32)


def _width(t) -> int:
    return t[0].numel()


def _groups(widths, max_cols: int = GROUP_COLS):
    """[(leaf_lo, leaf_hi, col_lo, col_hi)]: consecutive tensors grouped
    to at most max_cols packed columns each (one tensor wider than that
    is a group of its own)."""
    out, l0, c0, w = [], 0, 0, 0
    for j, lw in enumerate(widths):
        if w and w + lw > max_cols:
            out.append((l0, j, c0, c0 + w))
            l0, c0, w = j, c0 + w, 0
        w += lw
    if w:
        out.append((l0, len(widths), c0, c0 + w))
    return out


def _home_rows(src, pidx, n: int):
    """src [N, C] at the home rows' sources pidx [NH], a zero row where
    pidx = N (the pad row)."""
    return src.index_select(0, torch.clamp(pidx, max=n - 1)).masked_fill_(
        (pidx >= n)[:, None], 0.0)


def extract_home(tensors, plan: FramePlan, return_packed: bool = False):
    """Re-index each per-splat tensor ([N, ...] float32) of `tensors` into
    home order ([NH, ...]) through plan.pidx; the others (step counts)
    pass through. Copies of a fat parent start as identical rows, a dead
    row as zeros. The tensors are packed in column groups of at most
    GROUP_COLS, so the peak memory is one group's. Returns the list of
    home-order tensors, each a buffer of its own; with return_packed also
    the packed resort snapshot, one [NH, w] matrix per column group,
    which fold_back takes as its `hp0`."""
    tensors = list(tensors)
    n = plan.n
    li = [i for i, t in enumerate(tensors) if _per_splat(t, n)]
    widths = [_width(tensors[i]) for i in li]
    out, parts = list(tensors), []
    for l0, l1, _, _ in _groups(widths):
        src = torch.cat([tensors[li[j]].detach().reshape(n, -1) for j in range(l0, l1)], dim=1)
        home = _home_rows(src, plan.pidx, n)
        del src
        if return_packed:
            parts.append(home)
        o = 0
        for j in range(l0, l1):
            t = tensors[li[j]]
            leaf = home[:, o:o + widths[j]].reshape((plan.nh,) + tuple(t.shape[1:]))
            # the snapshot stays as it was: an optimizer's in-place step
            # must never write into it
            out[li[j]] = leaf.clone() if return_packed else leaf.contiguous()
            o += widths[j]
    return (out, parts) if return_packed else out


def fold_back(master, hp, hp0, plan: FramePlan, reduce: str = "mean", copy_cols=None):
    """Fold the home-order training since the resort back into splat
    order: master + reduce(hp − hp0), one list entry per tensor.

    master: tensors [N, ...] (others pass through: their folded value is
    hp's); hp: the home-order tensors in the same order; hp0: their value
    at the resort, the packed snapshot of extract_home(master, plan,
    return_packed=True). A primary
    row's delta goes back through the inverse permutation; a copy row's
    sums onto its parent (the copy-segment sums of the home gather's VJP,
    homesort.reduce_copy_segments).

    reduce="mean" divides each splat's summed delta by its live rows: a
    per-row Adam step is one step's size however a splat's gradient
    splits over its copies, so a sum would multiply a many-copy splat's
    step by its copy count (for a thin splat, one row, mean = sum).
    reduce="sum" is exact for gradient-linear optimizers (plain SGD).
    copy_cols: one bool per tensor (None: all True); a False tensor skips
    the copy segments and folds its primary row's delta alone, undivided.
    The True tensors must come first (the parameters before the moments),
    so the segment sums run over a prefix of each group's columns."""
    if reduce not in ("mean", "sum"):
        raise ValueError(f"unknown reduce {reduce!r}")
    master, hp = list(master), list(hp)
    if len(hp) != len(master):
        raise ValueError("fold_back: master and hp differ in length")
    n, nh = plan.n, plan.nh
    li = [i for i, t in enumerate(master) if _per_splat(t, n)]
    out = [t if i in li else hp[i] for i, t in enumerate(master)]
    widths = [_width(master[i]) for i in li]
    cmask = []
    for j, i in enumerate(li):
        cmask += [True if copy_cols is None else bool(copy_cols[i])] * widths[j]
    k_copy = sum(cmask)
    if any(cmask[k_copy:]):
        raise ValueError("copy_cols: the True tensors must come first (parameters "
                         "before moments)")
    groups = _groups(widths)
    if [h.shape for h in hp0] != [(nh, c1 - c0) for _, _, c0, c1 in groups]:
        raise ValueError("fold_back: hp0 is not the packed snapshot of these tensors")
    cnt = None  # the live-row count, from the first group, shared by the rest
    with torch.no_grad():
        for gi, (l0, l1, c0, c1) in enumerate(groups):
            m_g = torch.cat([master[li[j]].detach().reshape(n, -1) for j in range(l0, l1)], 1)
            h_g = torch.cat([hp[li[j]].detach().reshape(nh, -1) for j in range(l0, l1)], 1)
            kc = min(max(k_copy - c0, 0), c1 - c0)
            folded, cnt = _fold_group(m_g, h_g, hp0[gi], cnt, kc, reduce, plan)
            o = 0
            for j in range(l0, l1):
                out[li[j]] = folded[:, o:o + widths[j]].reshape(master[li[j]].shape)
                o += widths[j]
    return out


def _fold_group(m_g, h_g, h0_g, cnt, kc: int, reduce: str, plan: FramePlan):
    """One column group's fold: (master [N, C], home [NH, C], snapshot
    [NH, C], the live-row count or None, the copy-reduced prefix width)
    → (folded [N, C], the live-row count [N, 1])."""
    nh = plan.nh
    live = (plan.pidx < plan.n).to(torch.float32)[:, None]
    # only live rows carry state: a dead row's delta never reaches a splat
    d = (h_g - h0_g) * live
    need_cnt = cnt is None
    if kc or need_cnt:
        d = torch.cat([d, live], dim=1)  # the count rides as a last column
    dpad = torch.cat([d, torch.zeros_like(d[:1])])
    take = lambda idx: dpad[torch.clamp(idx, max=nh)]  # ≥ NH: truncated, zero
    red = take(plan.inv)
    if kc or need_cnt:
        red, cnt_live = red[:, :-1], red[:, -1:]
    f = plan.inv_tail.shape[0]
    if f and kc:
        d_tail = take(plan.inv_tail)
        seg = reduce_copy_segments(torch.cat([d_tail[:, :kc], d_tail[:, -1:]], dim=1),
                                   plan.seg_base)
        red = torch.cat([red[:, :kc] + seg[:, :-1], red[:, kc:]], dim=1)
        if need_cnt:
            cnt = torch.clamp(cnt_live + seg[:, -1:], min=1.0)
    elif need_cnt:
        seg = reduce_copy_segments(take(plan.inv_tail)[:, -1:], plan.seg_base) if f else 0.0
        cnt = torch.clamp(cnt_live + seg, min=1.0)
    if reduce == "mean" and kc:
        # the copy-reduced columns average over the live rows; the others
        # took exactly one row's delta
        red = torch.cat([red[:, :kc] / cnt, red[:, kc:]], dim=1)
    return m_g + red, cnt


# --------------------------------------------------------------------------
# the lazy step
# --------------------------------------------------------------------------


@trace.spanned("project")
def lazy_cols(hp: Gaussians, cam: Camera, cfg: RenderConfig):
    """The blend's attribute table [NH, 9] (composite.att_table's columns:
    mean2d, conic, rgb, opacity) of the home-order parameters under the
    current camera (project.project_table: on the card the projection
    kernel writes it). A row the fresh projection culls gets opacity 0,
    mean 0 and conic (1, 0, 1): it keeps its stale pairs and draws
    nothing. The means are absolute, as kernel C reads them (the
    reference's are relative to the home tile only for its bf16 split
    table)."""
    return project_table(hp, cam, cfg)


def _background(cfg: RenderConfig, like: torch.Tensor) -> torch.Tensor:
    """cfg.background [3] on like's device, filled there: a tensor copied
    from the host waits for the stream, and a lazy step never waits."""
    return torch.stack([torch.full((), float(b), dtype=torch.float32, device=like.device)
                        for b in cfg.background])


def lazy_render(hp: Gaussians, cam: Camera, cfg: RenderConfig, plan: FramePlan,
                return_aux: bool = False):
    """Render the plan's frozen layout with fresh attributes: [H, W, 3],
    differentiable in hp's fields (kernel C forward, kernel D backward;
    the gradients arrive in home order). return_aux adds the plan's
    overflow counters and the transmittance map."""
    cam = cam.to(hp.device)
    img_t, T_t = blend_stream(lazy_cols(hp, cam, cfg), plan.pid, plan.starts,
                              plan.ty0, plan.tiles_x, cfg)
    img, T_map = assemble_band(img_t, T_t, plan, cfg, bg=_background(cfg, img_t))
    img = img[: cam.height, : cam.width]
    if not return_aux:
        return img
    aux = dict(plan.ovf)
    aux["transmittance"] = T_map[: cam.height, : cam.width]
    return img, aux


def make_lazy_step(cfg: RenderConfig):
    """A lazy training step over home-order state: step(hp, opt, target,
    cam, plan) → loss, a 0-d tensor on the card (no host sync): mean
    squared error of lazy_render against target, its backward, one
    opt.step() on hp's parameters (updated in place). While a profile
    records, it counts the plan's home rows (`home_rows`) and those with a
    source splat (`home_rows_live`, a device tensor): the step projects
    every row, dead ones included."""

    @trace.spanned("step")
    def step(hp: Gaussians, opt, target, cam: Camera, plan: FramePlan) -> torch.Tensor:
        if trace.recording():
            trace.count("home_rows", plan.nh)
            trace.count("home_rows_live", (plan.pidx < plan.n).sum())
        with trace.span("optimizer"):
            opt.zero_grad(set_to_none=True)
        loss = torch.mean((lazy_render(hp, cam, cfg, plan) - target) ** 2)
        with trace.span("backward"):
            loss.backward()
        with trace.span("optimizer"):
            opt.step()
        return loss.detach()

    return step


# --------------------------------------------------------------------------
# the trainer: resort cadence and the fold-back's bookkeeping
# --------------------------------------------------------------------------


class LazyTrainer:
    """Lazy training: the master (g and its optimizer) in splat order, a
    home-order copy (hp and an optimizer of its own) between resorts.

        tr = LazyTrainer(g, cfg, torch.optim.Adam(g.parameters(), lr=1e-3))
        for cam, target in views:
            tr.resort(cam)                   # fold back, plan, extract
            for _ in range(steps_per_view):
                loss = tr.step(target, cam)
        tr.sync()                            # the last fold-back into g

    The first step after a resort is the exact path's step; the later
    ones reuse its layout with fresh attributes. At each fold-back the
    parameters average their rows' deltas (reduce="mean"; "sum" for plain
    SGD), and Adam's moments take their primary row's delta (averaging
    them like the parameters diverges in the reference). The packed
    resort snapshot is kept until the fold. The optimizer is
    torch.optim.Adam (its state in home order: both moments re-indexed,
    the step count carried over and back) or SGD without momentum. The
    home copy's optimizer has the master's groups and hyperparameters.
    g's parameters and the master optimizer's state tensors are updated
    in place at each fold-back. A resort's overflow counters are
    tr.plan.ovf."""

    def __init__(self, g: Gaussians, cfg: RenderConfig, optimizer, reduce: str = "mean"):
        adam = isinstance(optimizer, torch.optim.Adam)
        for group in optimizer.param_groups:
            if adam and (group.get("capturable") or group.get("fused") or group["amsgrad"]):
                raise ValueError("LazyTrainer: Adam with amsgrad, capturable or fused "
                                 "state is not supported")
            if not adam and not (isinstance(optimizer, torch.optim.SGD)
                                 and group["momentum"] == 0):
                raise ValueError("LazyTrainer: the optimizer must be torch.optim.Adam "
                                 "or SGD without momentum")
        names = {id(getattr(g, f)): f for f in FIELDS}
        owned = [names.get(id(p)) for grp in optimizer.param_groups for p in grp["params"]]
        if sorted(f for f in owned if f) != sorted(FIELDS) or None in owned:
            raise ValueError("LazyTrainer: the optimizer must hold g's five parameters")
        self.g, self.cfg, self.optimizer = g, cfg, optimizer
        self.reduce = reduce
        self.plan = self.hp = self.hp_opt = None
        self._h0 = None  # the packed resort snapshot, a buffer of its own
        self._step = make_lazy_step(cfg)
        if adam:  # Adam makes its state at the first step; the fold needs it now
            for grp in optimizer.param_groups:
                for p in grp["params"]:
                    if not optimizer.state[p]:
                        st = optimizer.state[p]
                        st["step"] = torch.tensor(0.0)
                        st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                        st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)

    def _state(self):
        """The master's tensors in the packed order: the five parameters,
        then each one's per-splat optimizer state (the moments); and the
        (field, state key) of each moment."""
        params = [getattr(self.g, f) for f in FIELDS]
        keys = [(f, k) for f, p in zip(FIELDS, params)
                for k in sorted(self.optimizer.state[p])
                if _per_splat(self.optimizer.state[p][k], self.g.means.shape[0])]
        moments = [self.optimizer.state[getattr(self.g, f)][k] for f, k in keys]
        return params, moments, keys

    def sync(self) -> Gaussians:
        """Fold the home-order progress back into g and the master
        optimizer's state (the step counts are the home copy's); returns
        g."""
        if self.plan is None:
            return self.g
        params, moments, keys = self._state()
        hstate = {f: self.hp_opt.state[getattr(self.hp, f)] for f in FIELDS}
        home = [getattr(self.hp, f) for f in FIELDS] + [hstate[f][k] for f, k in keys]
        copy = [True] * len(params) + [False] * len(moments)
        folded = fold_back(params + moments, home, self._h0, self.plan, self.reduce, copy)
        with torch.no_grad():
            for t, new in zip(params + moments, folded):
                t.copy_(new)
        for f in FIELDS:  # the rest of the state (Adam's step): the home copy's
            master = self.optimizer.state[getattr(self.g, f)]
            for k, v in hstate[f].items():
                if not _per_splat(v, self.plan.nh):
                    master[k] = v.clone() if isinstance(v, torch.Tensor) else v
        self.plan = self.hp = self.hp_opt = self._h0 = None
        return self.g

    @trace.spanned("resort")
    def resort(self, cam: Camera) -> FramePlan:
        """Fold back, build the frame plan at the current parameters and
        this camera, and extract the home-order state: the spans "fold",
        "plan" and "extract" under "resort"."""
        with trace.span("fold"):
            self.sync()
        with trace.span("plan"):
            self.plan = build_frame_plan(self.g, cam, self.cfg)
        with trace.span("extract"):
            return self._extract()

    def _extract(self) -> FramePlan:
        params, moments, keys = self._state()
        home, self._h0 = extract_home(params + moments, self.plan, return_packed=True)
        self.hp = Gaussians(*home[:len(FIELDS)])
        hp_of = {id(getattr(self.g, f)): getattr(self.hp, f) for f in FIELDS}
        self.hp_opt = type(self.optimizer)(
            [{**{k: v for k, v in grp.items() if k != "params"},
              "params": [hp_of[id(p)] for p in grp["params"]]}
             for grp in self.optimizer.param_groups])
        for f in FIELDS:
            master = self.optimizer.state[getattr(self.g, f)]
            self.hp_opt.state[getattr(self.hp, f)] = {
                k: v.clone() if isinstance(v, torch.Tensor) else v
                for k, v in master.items() if not _per_splat(v, self.plan.n)}
        for (f, k), t in zip(keys, home[len(FIELDS):]):
            self.hp_opt.state[getattr(self.hp, f)][k] = t
        return self.plan

    def step(self, target: torch.Tensor, cam: Camera) -> torch.Tensor:
        """One lazy step at `cam` toward `target` [H, W, 3]: the loss, a 0-d
        tensor on the card."""
        if self.plan is None:
            raise RuntimeError("call resort(cam) before step()")
        return self._step(self.hp, self.hp_opt, target, cam, self.plan)
