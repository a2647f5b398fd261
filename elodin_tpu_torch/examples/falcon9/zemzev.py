"""ZEM/ZEV terminal landing guidance in torch (counterpart of
``examples/falcon9/zemzev.py``): the accel-vector law with a hoverslam
time-to-go, a 150 m slow-down waypoint, a tilt-capped lateral divert and
a terminal vertical-only commit.  ``up`` is the unit vertical, r the
position relative to the pad, v the velocity; the result is the
commanded thrust acceleration (gravity-compensated)."""

from __future__ import annotations

import math

import numpy as np
import torch

from .._consts import const, f64

G = 9.81
WAYPOINT_ALT_M = 150.0
WAYPOINT_VDOWN_MPS = 25.0
V_TD_MPS = 1.2  # target touchdown sink rate
TILT_CAP_RAD = 0.25
A_LAND_MPS2 = 12.0  # single-engine-class net vertical accel for t_go
A_THRUST_MAX = 35.0  # 3-engine thrust-acceleration ceiling
COMMIT_ALT_M = 50.0
COMMIT_TGO_S = 5.0
_TAN_TILT_CAP = math.tan(TILT_CAP_RAD)
_UP = np.array([0.0, 0.0, 1.0])


def _dot(a, b):
    return (a * b).sum(-1)


def t_go_hoverslam(alt_m, vdown_mps, a_land=A_LAND_MPS2):
    """(clipped t_go, raw t_go) of a feasible hoverslam: the braking accel
    that stops v_down at V_TD over the remaining altitude, clamped into the
    single-engine class; the raw value drives the commit decision."""
    h = torch.clamp(f64(alt_m), min=0.5)
    vd = torch.clamp(f64(vdown_mps), min=0.1)
    a_req = torch.clamp(vd * vd - V_TD_MPS * V_TD_MPS, min=0.0) / (2.0 * h)
    a_use = torch.clamp(a_req, 0.5, a_land)
    t_raw = (vd - V_TD_MPS) / a_use
    return torch.clamp(t_raw, 0.5, 80.0), t_raw


def commit_flag(alt_m, t_raw):
    """Vertical-only commit: near the deck, or t_go collapsing close to it."""
    return (alt_m < COMMIT_ALT_M) | ((t_raw > 0.0) & (t_raw < COMMIT_TGO_S) & (alt_m < 200.0))


def accel_cmd(r, v, up, t_go, commit):
    """Commanded thrust acceleration for the landing burn (local frame):
    before commit the optimal-rendezvous accel 6 ZEM/t_go^2 - 2 ZEV/t_go
    minus gravity toward the 150 m waypoint (until below it), lateral part
    capped at tan(TILT_CAP) of the vertical; after commit pure vertical,
    braking the sink rate toward V_TD."""
    alt = _dot(r, up)
    g_vec = -G * up
    vdown = -_dot(v, up)

    high = alt > WAYPOINT_ALT_M
    # (a where of two Python floats would be float32)
    r_tgt = torch.where(high, WAYPOINT_ALT_M, torch.zeros_like(alt))[..., None] * up
    v_tgt = torch.where(high, -WAYPOINT_VDOWN_MPS, torch.full_like(alt, -V_TD_MPS))[..., None] * up

    t_go = t_go[..., None]
    zem = r_tgt - (r + v * t_go + 0.5 * g_vec * t_go**2)
    zev = v_tgt - (v + g_vec * t_go)
    a = 6.0 * zem / t_go**2 - 2.0 * zev / t_go - g_vec

    a_up = _dot(a, up)
    a_lat = a - a_up[..., None] * up
    lat = torch.linalg.vector_norm(a_lat, dim=-1)
    lat_max = torch.where(a_up > 1.0, torch.abs(a_up) * _TAN_TILT_CAP, 0.0)
    scale = torch.where(lat > torch.clamp(lat_max, min=1e-6),
                        lat_max / torch.clamp(lat, min=1e-6), 1.0)
    a_guided = a_up[..., None] * up + scale[..., None] * a_lat

    a_commit = (G + 3.0 * (vdown - V_TD_MPS))[..., None] * up
    return torch.where(commit[..., None], a_commit, a_guided)


def step(r, v, up, dt, a_max=A_THRUST_MAX):
    """One closed-loop guidance + dynamics step (offline replay, tests)."""
    alt = _dot(r, up)
    t_go, t_raw = t_go_hoverslam(alt, -_dot(v, up))
    a = accel_cmd(r, v, up, t_go, commit_flag(alt, t_raw))
    mag = torch.linalg.vector_norm(a, dim=-1)
    a = a * torch.clamp(a_max / torch.clamp(mag, min=1e-9), max=1.0)[..., None]
    v_new = v + (a - G * up) * dt
    return r + v_new * dt, v_new


def replay(r0, v0, n_steps: int = 20_000, dt: float = 0.05):
    """Integrate from a landing-burn ignition state until touchdown, as a
    Python loop over ``n_steps``; returns (r, v) at ground contact
    (interpolated onto alt = 0)."""
    r, v = f64(r0), f64(v0)
    up = const(_UP, r)
    done = torch.zeros(r.shape[:-1], dtype=torch.bool, device=r.device)
    for _ in range(n_steps):
        r_n, v_n = step(r, v, up, dt)
        crossing = (~done) & (r_n[..., 2] <= 0.0)
        frac = torch.where(crossing, r_n[..., 2] / torch.clamp(v_n[..., 2] * dt, max=-1e-12), 0.0)
        r_c = r_n - v_n * dt * frac[..., None]
        r_c = torch.cat([r_c[..., :2], torch.clamp(r_c[..., 2:], min=0.0)], dim=-1)
        r = torch.where(done[..., None], r, torch.where(crossing[..., None], r_c, r_n))
        v = torch.where(done[..., None], v, v_n)
        done = done | crossing
    return r, v


def ignition_state(miss_m=391.0, vlat_mps=46.9, vdown_mps=271.0, alt_m=3000.0,
                   toward=0.16):
    """The recorded bad ignition state of the gate tests: ``toward`` is the
    fraction of lateral speed pointed at the target."""
    r = torch.tensor([-miss_m, 0.0, alt_m], dtype=torch.float64)
    cross = math.sqrt(max(1.0 - toward**2, 0.0))
    v = torch.tensor([vlat_mps * toward, vlat_mps * cross, -vdown_mps], dtype=torch.float64)
    return r, v
