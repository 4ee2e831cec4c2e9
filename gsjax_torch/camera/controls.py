"""Headless orbit controls — the PyTorch counterpart of
gsjax/camera/controls.py: the reference's interactive camera
(OrbitControls) as a pure state machine on immutable dataclasses.

`state = apply_event(state, event, params)` feeds input, `state =
update(state, params)` advances one frame (the reference calls update()
once a rendered frame) and `to_camera(state, ...)` gives the frame's
Camera. Plain numpy throughout, as in the reference package, so a
recorded event stream replays deterministically; the port keeps its own
copy and imports nothing of gsjax.

The law, as the reference's:
  * orbit drag:  dα = −dx·orbit_speed·0.003, dβ = +dy·orbit_speed·0.003,
                 β clamped to [min_angle, max_angle] degrees
  * pan drag:    target += right·(−dx·pan_speed·0.01·zoom_norm)
                        + up·(−dy·pan_speed·0.01·zoom_norm), right / up the
                 columns 0 / 1 of the camera rotation
  * wheel zoom:  radius += Δy·zoom_speed·0.025·zoom_norm, clamped
  * zoom_norm:   0.1 + 0.9·(radius − min_zoom)/(max_zoom − min_zoom)
  * pinch zoom:  radius += (last_dist − dist)·zoom_speed·0.1·zoom_norm, and
                 two-finger pan at 0.025·zoom_norm
  * each frame:  x ← lerp(x, desired_x, dampening) for α, β, radius, target
  * pose:        position = target + radius·(sinα·cosβ, −sinβ, −cosα·cosβ),
                 rotation = Euler(asin(−dir.y), atan2(dir.x, dir.z), 0) of
                 dir = normalize(target − position)
  * keyboard:    WASD / arrows move the target along the camera's forward /
                 right at 0.025, E/Q/R/F orbit at 0.01 rad, applied in
                 update after the pose step
  * static cam:  set_camera() freezes updates until the next key press or
                 nonzero drag
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from gsjax_torch.core.camera import Camera

_V3 = Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class OrbitParams:
    """Tunables (≙ OrbitControls.ts:6-14; angles in degrees like the
    reference's minAngle/maxAngle)."""

    min_angle: float = -90.0
    max_angle: float = 90.0
    min_zoom: float = 0.1
    max_zoom: float = 30.0
    orbit_speed: float = 1.0
    pan_speed: float = 1.0
    zoom_speed: float = 1.0
    dampening: float = 0.12


@dataclasses.dataclass(frozen=True)
class OrbitState:
    """Full controller state. `alpha/beta/radius/target` are the damped
    values, `d_*` the input-driven desired values (≙ the closure locals
    alpha/desiredAlpha …, OrbitControls.ts:34-48). `position`/`rotation`
    (camera-to-world matrix, row-major) hold the pose written by the last
    update — pan and keyboard moves read their basis columns from it."""

    alpha: float = 0.5
    beta: float = 0.5
    radius: float = 5.0
    target: _V3 = (0.0, 0.0, 0.0)
    d_alpha: float = 0.5
    d_beta: float = 0.5
    d_radius: float = 5.0
    d_target: _V3 = (0.0, 0.0, 0.0)
    dragging: bool = False
    panning: bool = False
    last_x: float = 0.0
    last_y: float = 0.0
    last_dist: float = 0.0
    keys: frozenset = frozenset()
    static_cam: bool = False
    position: _V3 = (0.0, 0.0, 0.0)
    rotation: tuple = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))


# -- events ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MouseDown:
    x: float
    y: float
    button: int = 0  # 2 = right button → panning (:117-124)


@dataclasses.dataclass(frozen=True)
class MouseUp:
    pass


@dataclasses.dataclass(frozen=True)
class MouseMove:
    x: float
    y: float


@dataclasses.dataclass(frozen=True)
class Wheel:
    delta_y: float


@dataclasses.dataclass(frozen=True)
class KeyDown:
    code: str  # "KeyW", "ArrowUp", …


@dataclasses.dataclass(frozen=True)
class KeyUp:
    code: str


@dataclasses.dataclass(frozen=True)
class TouchStart:
    touches: tuple  # ((x, y), …) — 1 finger orbits, 2 pan/pinch


@dataclasses.dataclass(frozen=True)
class TouchEnd:
    pass


@dataclasses.dataclass(frozen=True)
class TouchMove:
    touches: tuple


@dataclasses.dataclass(frozen=True)
class SetCameraTarget:
    """≙ setCameraTarget (OrbitControls.ts:95-103): re-derive desired
    (radius, beta, alpha, target) so the CURRENT camera position orbits
    the new target."""

    target: _V3


_ARROW_TO_WASD = {
    "ArrowUp": "KeyW",
    "ArrowDown": "KeyS",
    "ArrowLeft": "KeyA",
    "ArrowRight": "KeyD",
}


def _zoom_norm(d_radius: float, p: OrbitParams) -> float:
    return 0.1 + (0.9 * (d_radius - p.min_zoom)) / (p.max_zoom - p.min_zoom)


def _clamp_beta(beta: float, p: OrbitParams) -> float:
    return min(
        max(beta, p.min_angle * np.pi / 180.0), p.max_angle * np.pi / 180.0
    )


def _basis(state: OrbitState):
    """right / up / forward from the stored rotation — the reference reads
    matrix columns (R[0],R[3],R[6]) etc. (:152-154, :291-293)."""
    R = np.asarray(state.rotation, np.float64)
    right = R[:, 0]
    up = R[:, 1]
    forward = -R[:, 2]
    return right, up, forward


def _orbit_delta(state: OrbitState, dx, dy, p: OrbitParams):
    d_alpha = state.d_alpha - dx * p.orbit_speed * 0.003
    d_beta = _clamp_beta(state.d_beta + dy * p.orbit_speed * 0.003, p)
    return d_alpha, d_beta


def apply_event(
    state: OrbitState, event, params: OrbitParams = OrbitParams()
) -> OrbitState:
    """Pure event transition (the reference's DOM handlers,
    OrbitControls.ts:108-258)."""
    p = params
    r = dataclasses.replace

    if isinstance(event, MouseDown):
        return r(
            state,
            dragging=True,
            panning=event.button == 2,
            last_x=event.x,
            last_y=event.y,
        )
    if isinstance(event, (MouseUp, TouchEnd)):
        return r(state, dragging=False, panning=False)
    if isinstance(event, MouseMove):
        if not state.dragging:
            return state
        dx = event.x - state.last_x
        dy = event.y - state.last_y
        if state.panning:
            zn = _zoom_norm(state.d_radius, p)
            right, up, _ = _basis(state)
            t = np.asarray(state.d_target, np.float64)
            t = t + right * (-dx * p.pan_speed * 0.01 * zn)
            t = t + up * (-dy * p.pan_speed * 0.01 * zn)
            state = r(state, d_target=tuple(t))
        else:
            d_alpha, d_beta = _orbit_delta(state, dx, dy, p)
            state = r(state, d_alpha=d_alpha, d_beta=d_beta)
        moved = dx != 0.0 or dy != 0.0
        return r(
            state,
            last_x=event.x,
            last_y=event.y,
            static_cam=state.static_cam and not moved,
        )
    if isinstance(event, Wheel):
        zn = _zoom_norm(state.d_radius, p)
        d_radius = state.d_radius + event.delta_y * p.zoom_speed * 0.025 * zn
        return r(state, d_radius=min(max(d_radius, p.min_zoom), p.max_zoom))
    if isinstance(event, KeyDown):
        code = event.code
        keys = set(state.keys) | {code}
        if code in _ARROW_TO_WASD:
            keys.add(_ARROW_TO_WASD[code])
        return r(state, keys=frozenset(keys), static_cam=False)
    if isinstance(event, KeyUp):
        code = event.code
        keys = set(state.keys) - {code}
        if code in _ARROW_TO_WASD:
            keys.discard(_ARROW_TO_WASD[code])
        return r(state, keys=frozenset(keys))
    if isinstance(event, TouchStart):
        ts = event.touches
        if len(ts) == 1:
            return r(
                state, dragging=True, panning=False,
                last_x=ts[0][0], last_y=ts[0][1], last_dist=0.0,
            )
        if len(ts) >= 2:
            (x0, y0), (x1, y1) = ts[0], ts[1]
            return r(
                state, dragging=True, panning=True,
                last_x=(x0 + x1) / 2.0, last_y=(y0 + y1) / 2.0,
                last_dist=float(np.hypot(x0 - x1, y0 - y1)),
            )
        return state
    if isinstance(event, TouchMove):
        if not state.dragging:
            return state
        ts = event.touches
        if state.panning and len(ts) >= 2:
            (x0, y0), (x1, y1) = ts[0], ts[1]
            zn = _zoom_norm(state.d_radius, p)
            dist = float(np.hypot(x0 - x1, y0 - y1))
            d_radius = state.d_radius + (
                (state.last_dist - dist) * p.zoom_speed * 0.1 * zn
            )
            d_radius = min(max(d_radius, p.min_zoom), p.max_zoom)
            tx, ty = (x0 + x1) / 2.0, (y0 + y1) / 2.0
            dx, dy = tx - state.last_x, ty - state.last_y
            right, up, _ = _basis(state)
            t = np.asarray(state.d_target, np.float64)
            t = t + right * (-dx * p.pan_speed * 0.025 * zn)
            t = t + up * (-dy * p.pan_speed * 0.025 * zn)
            return r(
                state, d_radius=d_radius, d_target=tuple(t),
                last_x=tx, last_y=ty, last_dist=dist,
            )
        dx = ts[0][0] - state.last_x
        dy = ts[0][1] - state.last_y
        d_alpha, d_beta = _orbit_delta(state, dx, dy, p)
        return r(
            state, d_alpha=d_alpha, d_beta=d_beta,
            last_x=ts[0][0], last_y=ts[0][1],
        )
    if isinstance(event, SetCameraTarget):
        pos = np.asarray(state.position, np.float64)
        tgt = np.asarray(event.target, np.float64)
        d = tgt - pos
        return r(
            state,
            d_radius=float(np.linalg.norm(d)),
            d_beta=float(np.arctan2(d[1], np.hypot(d[0], d[2]))),
            d_alpha=float(-np.arctan2(d[0], d[2])),
            d_target=tuple(tgt),
        )
    raise TypeError(f"unknown control event {event!r}")


def _pose(alpha, beta, radius, target):
    """Position + camera rotation matrix for an orbit state
    (≙ OrbitControls.ts:279-283 and Quaternion.FromEuler/Matrix3 —
    expanded analytically: rx = −β, ry = −α)."""
    t = np.asarray(target, np.float64)
    ca, sa = np.cos(alpha), np.sin(alpha)
    cb, sb = np.cos(beta), np.sin(beta)
    pos = t + radius * np.array([sa * cb, -sb, -ca * cb])
    # direction = normalize(target − position) = (−sa·cb, sb, ca·cb);
    # rx = asin(−dir.y), ry = atan2(dir.x, dir.z) (literal :280-282);
    # R = Rot(Euler(rx, ry, 0)) = Ry(ry)·Rx(rx), the reference's
    # FromEuler + RotationFromQuaternion expanded:
    rx = np.arcsin(-np.clip(sb, -1.0, 1.0))
    ry = np.arctan2(-sa * cb, ca * cb)
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    R = np.array(
        [
            [cy, sx * sy, cx * sy],
            [0.0, cx, -sx],
            [-sy, sx * cy, cx * cy],
        ]
    )
    return pos, R


def update(state: OrbitState, params: OrbitParams = OrbitParams()) -> OrbitState:
    """One frame: damped lerp toward desired, pose refresh, then keyboard
    moves (≙ OrbitControls.ts:264-307 — keys act on the NEW pose)."""
    if state.static_cam:
        return state
    p = params
    lerp = lambda a, b: (1.0 - p.dampening) * a + p.dampening * b
    alpha = lerp(state.alpha, state.d_alpha)
    beta = lerp(state.beta, state.d_beta)
    radius = lerp(state.radius, state.d_radius)
    target = tuple(
        lerp(np.asarray(state.target, np.float64),
             np.asarray(state.d_target, np.float64))
    )
    pos, R = _pose(alpha, beta, radius, target)
    state = dataclasses.replace(
        state, alpha=alpha, beta=beta, radius=radius, target=target,
        position=tuple(pos), rotation=tuple(map(tuple, R)),
    )

    move_speed = 0.025
    rotate_speed = 0.01
    right, _, forward = _basis(state)
    d_target = np.asarray(state.d_target, np.float64)
    keys = state.keys
    if "KeyS" in keys:
        d_target = d_target + forward * move_speed
    if "KeyW" in keys:
        d_target = d_target - forward * move_speed
    if "KeyA" in keys:
        d_target = d_target - right * move_speed
    if "KeyD" in keys:
        d_target = d_target + right * move_speed
    d_alpha = state.d_alpha
    d_beta = state.d_beta
    if "KeyE" in keys:
        d_alpha += rotate_speed
    if "KeyQ" in keys:
        d_alpha -= rotate_speed
    if "KeyR" in keys:
        d_beta += rotate_speed
    if "KeyF" in keys:
        d_beta -= rotate_speed
    return dataclasses.replace(
        state, d_target=tuple(d_target), d_alpha=d_alpha, d_beta=d_beta
    )


def set_camera(state: OrbitState) -> OrbitState:
    """≙ setCamera (OrbitControls.ts:73-81): freeze updates (staticCam)
    and reset the drag state; the next key press or nonzero drag unfreezes."""
    return dataclasses.replace(
        state, static_cam=True, dragging=False, panning=False,
        last_x=0.0, last_y=0.0, last_dist=0.0,
    )


def to_camera(state: OrbitState, **cam_kwargs) -> Camera:
    """The Camera of the current pose: at `position`, looking at `target`
    (the reference's rotation law makes the camera look at the orbit
    target by construction, so look_at reproduces it in the OpenCV-
    convention basis). `cam_kwargs` go to Camera.create: intrinsics,
    image size and device (the card unless device="cpu")."""
    return Camera.look_at(state.position, state.target, **cam_kwargs)
