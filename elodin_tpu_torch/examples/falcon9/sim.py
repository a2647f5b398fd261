"""Falcon 9 RTLS booster mission in torch (counterpart of
``examples/falcon9/sim.py``): liftoff, gravity-turn ascent, MECO and
staging, RCS flip, boostback, entry burn, aero descent on grid fins and a
ZEM/ZEV landing burn to a propulsive touchdown at LZ-1, simulated in the
rotating ECEF frame with the flight software in the tick.

Every system keeps the JAX example's arithmetic in the same order, so a
tick of the port agrees with a tick of the JAX package to f64 round-off.
``jnp.select`` is a nested ``torch.where``, ``lax.scan`` a Python loop.
The sensor suite draws its six noise streams of a tick in one batched
threefry (``sensors.noise_streams``), which gives the JAX package's
values.

Body frame: +X nose; engines at station 0 thrust along +X.  (This module
defines ``@el.system`` functions, so it must not use postponed
annotations.)
"""

import math
import typing as ty
from dataclasses import dataclass, field

import numpy as np
import torch

import elodin_tpu_torch as el

from ... import frames
from . import aero
from . import atmosphere
from . import propulsion as prop_mod
from . import rcs as rcs_mod
from . import sensors as sn
from . import zemzev
from .._consts import const
from .constants import (
    ENGINE_A_E_M2,
    ENGINE_SHUTDOWN_TAU_S,
    ENGINE_SPINUP_TAU_S,
    ENGINE_T_VAC_N,
    ENGINE_THROTTLE_TAU_S,
    FIN_MAX_RAD,
    FIN_RATE_RADPS,
    FIN_TAU_S,
    G0,
    LOX_LOAD_KG,
    LZ1_ALT_M,
    LZ1_LAT_DEG,
    LZ1_LON_DEG,
    MU_EARTH_M3S2,
    N_ENGINES,
    OMEGA_EARTH_RADPS,
    PAD_ALT_M,
    PAD_LAT_DEG,
    PAD_LON_DEG,
    RCS_VALVE_TAU_S,
    RP1_LOAD_KG,
    STAGE1_DRY_MASS_KG,
    STAGE1_PROP_KG,
    STAGE2_AND_PAYLOAD_KG,
    TANK_P_NOM_PA,
    THROTTLE_MIN,
    TVC_MAX_RAD,
    TVC_RATE_RADPS,
    TVC_TAU_S,
)

# --- rates -------------------------------------------------------------------
SIM_RATE_HZ = 100.0
GUIDANCE_EVERY_TICKS = 5  # GNC at 20 Hz against the 100 Hz plant (build())
SIM_TIME_STEP = 1.0 / SIM_RATE_HZ
DEFAULT_MAX_TICKS = 58_000  # 580 s with dispersion margin

# --- mission schedule (CRS-12-like) -----------------------------------------
T_PITCH_START_S = 7.0
MECO_RESERVE_KG = 70_000.0
T_MECO_MIN_S, T_MECO_MAX_S = 60.0, 160.0
SEP_DELAY_S = 4.0  # MECO -> stage separation
FLIP_MIN_S = 14.0  # separation -> earliest boostback light
FLIP_TIMEOUT_S = 34.0
BOOSTBACK_ATT_GATE_RAD = 0.5
ENTRY_BURN_ALT_M = 45_000.0
ENTRY_BURN_EXIT_SPEED_MPS = 650.0
ENTRY_STEER_MAX_RAD = 0.30
PITCH_KICK_DEG = 2.4
ASCENT_AZIMUTH_DEG = 45.0
BOOSTBACK_AIM_BIAS_M = 3_000.0
BOOSTBACK_THROTTLE = 0.70
ENTRY_THROTTLE = 0.65
LANDING_ARM_ALT_M = 6_000.0
LANDING_IGNITION_MARGIN = 1.05
LANDING_SPOOL_CHARGE_S = 2.5
BUCKET_Q_ON_PA = 30_000.0
BUCKET_THROTTLE = 0.80
ASCENT_G_LIMIT = 34.0
LANDING_KV_HIGH = 3.2
LANDING_KV_LOW = 4.0
COMMIT_MISS_MAX_M = 25.0
LANDING_KLAT_POST = 1.2

# Attitude-loop bandwidth schedule.
ATT_WN_TVC = 0.9
ATT_WN_TVC_LANDING = 1.7
ATT_ZETA_TVC = 0.9
ATT_WN_RCS = 0.35
ATT_ZETA_RCS = 0.8
RCS_DEADBAND_ATT_RAD = 0.009
RCS_DEADBAND_RATE_RADPS = 0.01
FIN_Q_MIN_PA = 2_000.0
TVC_THRUST_MIN_N = 2.0e5
STEER_TILT_MAX_RAD = 0.25

# Per-engine TEA-TEB charges: the center trio (indices 0-2) can relight.
INITIAL_CHARGES = np.array([4.0, 4.0, 4.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0])
MASK_ALL = np.ones(N_ENGINES)
MASK_TRIO = np.array([1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
MASK_CENTER = np.array([1.0] + [0.0] * (N_ENGINES - 1))

# phase ids (monotone ladder)
ASCENT, FLIP, BOOSTBACK, COAST, ENTRY, DESCENT, LANDING, DOWN = range(8)

# --- dispersions -------------------------------------------------------------
PARAMS = dict(
    thrust_eff=el.monte_carlo.Param(float, default=1.0, min=0.96, max=1.04),
    dry_mass=el.monte_carlo.Param(float, default=STAGE1_DRY_MASS_KG, min=24_000.0,
                                  max=27_000.0),
    wind_e=el.monte_carlo.Param(float, default=0.0, min=-12.0, max=12.0),
    wind_n=el.monte_carlo.Param(float, default=0.0, min=-12.0, max=12.0),
    cd_descent=el.monte_carlo.Param(float, default=1.30, min=1.1, max=1.5),
)
CD_DESCENT_NOMINAL = 1.30  # scales the CA_DESCENT table

# --- components --------------------------------------------------------------
_F = el.ComponentType.F64
_F2 = el.ComponentType(el.PrimitiveType.F64, (2,))
_F3 = el.ComponentType(el.PrimitiveType.F64, (3,))
_F4 = el.ComponentType(el.PrimitiveType.F64, (4,))
_F8 = el.ComponentType(el.PrimitiveType.F64, (8,))
_F9 = el.ComponentType(el.PrimitiveType.F64, (9,))
T = torch.Tensor

Prop = ty.Annotated[T, el.Component("prop_kg", _F)]
Phase = ty.Annotated[T, el.Component("phase", _F)]
Throttle = ty.Annotated[T, el.Component("throttle", _F)]
EnginesLit = ty.Annotated[T, el.Component("engines_lit", _F)]
EngineCmd = ty.Annotated[T, el.Component("engine_cmd", _F9)]
EngineSpool = ty.Annotated[T, el.Component("engine_spool", _F9)]
EngineLitState = ty.Annotated[T, el.Component("engine_lit_state", _F9)]
TeatebCharges = ty.Annotated[T, el.Component("teateb_charges", _F9)]
ThrustTotal = ty.Annotated[T, el.Component("thrust_total", _F)]
ThrustDir = ty.Annotated[T, el.Component("thrust_dir", _F3, metadata={"element_names": "x,y,z"})]
ThrustEff = ty.Annotated[T, el.Component("thrust_eff", _F)]
DryMass = ty.Annotated[T, el.Component("dry_mass", _F)]
Wind = ty.Annotated[T, el.Component("wind", _F3, metadata={"element_names": "e,n,u"})]
CdDescent = ty.Annotated[T, el.Component("cd_descent", _F)]
CgStation = ty.Annotated[T, el.Component("cg_station", _F)]
Qbar = ty.Annotated[T, el.Component("qbar", _F)]
MachNum = ty.Annotated[T, el.Component("mach", _F)]
TvcCmd = ty.Annotated[T, el.Component("tvc_cmd", _F2)]
TvcState = ty.Annotated[T, el.Component("tvc_state", _F2)]
FinCmd = ty.Annotated[T, el.Component("fin_cmd", _F4)]
FinState = ty.Annotated[T, el.Component("fin_state", _F4)]
RcsCmd = ty.Annotated[T, el.Component("rcs_cmd", _F8)]
RcsState = ty.Annotated[T, el.Component("rcs_state", _F8)]
TankPressure = ty.Annotated[T, el.Component("tank_pressure", _F2)]
InletPressure = ty.Annotated[T, el.Component("inlet_pressure", _F2)]
SpecForceBody = ty.Annotated[T, el.Component("spec_force_body", _F3)]
Lifted = ty.Annotated[T, el.Component("lifted", _F)]
MecoT = ty.Annotated[T, el.Component("meco_t", _F)]
LandSingle = ty.Annotated[T, el.Component("land_single", _F)]
LandCommit = ty.Annotated[T, el.Component("land_commit", _F)]
TouchdownVz = ty.Annotated[T, el.Component("touchdown_vz", _F)]
TouchdownVlat = ty.Annotated[T, el.Component("touchdown_vlat", _F)]
TouchdownTilt = ty.Annotated[T, el.Component("touchdown_tilt", _F)]
MissDistance = ty.Annotated[T, el.Component("miss_distance", _F)]

# --- pad geometry (static, computed at import) -------------------------------
_PAD_ECEF = frames.geodetic_to_ecef(
    np.radians(PAD_LAT_DEG), np.radians(PAD_LON_DEG), PAD_ALT_M).numpy()
_LZ1_ECEF = frames.geodetic_to_ecef(
    np.radians(LZ1_LAT_DEG), np.radians(LZ1_LON_DEG), LZ1_ALT_M).numpy()
_R_NED = frames.ecef_to_ned(np.radians(PAD_LAT_DEG), np.radians(PAD_LON_DEG)).numpy()
_E_HAT, _N_HAT, _U_HAT = _R_NED[1], _R_NED[0], -_R_NED[2]
_LZ1_ENU = np.array([
    float(_E_HAT @ (_LZ1_ECEF - _PAD_ECEF)),
    float(_N_HAT @ (_LZ1_ECEF - _PAD_ECEF)),
    float(_U_HAT @ (_LZ1_ECEF - _PAD_ECEF)),
])
_R_PAD_SURFACE = float(np.linalg.norm(_PAD_ECEF)) - PAD_ALT_M
_LZ1_Z = float(_LZ1_ENU[2])
_LZ1_XY = np.ascontiguousarray(_LZ1_ENU[:2])
# the pad-ENU basis as the rows of one matrix: ECEF -> ENU is one matvec
_ENU = np.stack([_E_HAT, _N_HAT, _U_HAT])
_ENU_T = np.ascontiguousarray(_ENU.T)

_UP = np.array([0.0, 0.0, 1.0])
_X_HAT = np.array([1.0, 0.0, 0.0])
_MINUS_X_HAT = np.array([-1.0, 0.0, 0.0])
_W_EARTH = np.array([0.0, 0.0, OMEGA_EARTH_RADPS])
_AZ = math.radians(ASCENT_AZIMUTH_DEG)
_DOWNRANGE = np.array([math.sin(_AZ), math.cos(_AZ), 0.0])
_PITCH_KICK_RAD = math.radians(PITCH_KICK_DEG)
_TAN_1_DEG = math.tan(math.radians(1.0))
_ROLL_FREE = np.array([0.0, 1.0, 1.0])
_RADAR_BORESIGHT = np.array([-1.0, 0.0, 0.0])
_ONE_MINUS_UP = 1.0 - _UP


def _norm(x: T) -> T:
    return torch.linalg.vector_norm(x, dim=-1)


def _dot(a: T, b: T) -> T:
    return (a * b).sum(-1)


def _cross(a: T, b: T) -> T:
    """``jnp.cross``, promoting an f32 operand to f64 as JAX does (the mixed
    policy keeps most columns in f32)."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.linalg.cross(a.to(dtype), b.to(dtype), dim=-1)


def _select(conds, values, default: T) -> T:
    """``jnp.select``: the value of the first true condition, else
    ``default``."""
    out = default
    for c, v in zip(reversed(conds), reversed(values)):
        out = torch.where(c, v, out)
    return out


def to_enu(r_ecef: T) -> T:
    return const(_ENU, r_ecef) @ (r_ecef - const(_PAD_ECEF, r_ecef))


def vec_enu(v_ecef: T) -> T:
    return const(_ENU, v_ecef) @ v_ecef


def from_enu_dir(d_enu: T) -> T:
    return const(_ENU_T, d_enu) @ d_enu


def altitude_m(r_ecef: T) -> T:
    """Spherical altitude above the pad surface radius."""
    return _norm(r_ecef) - _R_PAD_SURFACE


def lox_rp1(prop_kg):
    return (prop_kg * (LOX_LOAD_KG / STAGE1_PROP_KG), prop_kg * (RP1_LOAD_KG / STAGE1_PROP_KG))


def upright_attitude() -> el.Quaternion:
    """Body +X onto the pad's local up."""
    up = np.asarray(_U_HAT)
    x = np.array([1.0, 0.0, 0.0])
    axis = np.cross(x, up)
    axis = axis / np.linalg.norm(axis)
    ang = float(np.arccos(np.clip(x @ up, -1.0, 1.0)))
    return el.Quaternion.from_axis_angle(torch.as_tensor(axis), torch.tensor(ang, dtype=torch.float64))


def _f(x) -> np.ndarray:
    return np.float64(x)


@dataclass
class Booster(el.Archetype):
    prop_kg: Prop = field(default_factory=lambda: _f(STAGE1_PROP_KG))
    phase: Phase = field(default_factory=lambda: _f(ASCENT))
    throttle: Throttle = field(default_factory=lambda: _f(1.0))
    engines_lit: EnginesLit = field(default_factory=lambda: _f(0.0))
    engine_cmd: EngineCmd = field(default_factory=lambda: MASK_ALL.copy())
    engine_spool: EngineSpool = field(default_factory=lambda: np.zeros(N_ENGINES))
    engine_lit_state: EngineLitState = field(default_factory=lambda: np.zeros(N_ENGINES))
    teateb_charges: TeatebCharges = field(default_factory=lambda: INITIAL_CHARGES.copy())
    thrust_total: ThrustTotal = field(default_factory=lambda: _f(0.0))
    thrust_dir: ThrustDir = field(default_factory=lambda: _U_HAT.copy())
    thrust_eff: ThrustEff = field(default_factory=lambda: _f(1.0))
    dry_mass: DryMass = field(default_factory=lambda: _f(STAGE1_DRY_MASS_KG))
    wind: Wind = field(default_factory=lambda: np.zeros(3))
    cd_descent: CdDescent = field(default_factory=lambda: _f(CD_DESCENT_NOMINAL))
    cg_station: CgStation = field(default_factory=lambda: _f(25.0))
    qbar: Qbar = field(default_factory=lambda: _f(0.0))
    mach: MachNum = field(default_factory=lambda: _f(0.0))
    tvc_cmd: TvcCmd = field(default_factory=lambda: np.zeros(2))
    tvc_state: TvcState = field(default_factory=lambda: np.zeros(2))
    fin_cmd: FinCmd = field(default_factory=lambda: np.zeros(4))
    fin_state: FinState = field(default_factory=lambda: np.zeros(4))
    rcs_cmd: RcsCmd = field(default_factory=lambda: np.zeros(8))
    rcs_state: RcsState = field(default_factory=lambda: np.zeros(8))
    tank_pressure: TankPressure = field(default_factory=lambda: np.full(2, TANK_P_NOM_PA))
    inlet_pressure: InletPressure = field(default_factory=lambda: np.full(2, TANK_P_NOM_PA))
    spec_force_body: SpecForceBody = field(default_factory=lambda: np.zeros(3))
    lifted: Lifted = field(default_factory=lambda: _f(0.0))
    meco_t: MecoT = field(default_factory=lambda: _f(-1.0))
    land_single: LandSingle = field(default_factory=lambda: _f(0.0))
    land_commit: LandCommit = field(default_factory=lambda: _f(0.0))
    touchdown_vz: TouchdownVz = field(default_factory=lambda: _f(0.0))
    touchdown_vlat: TouchdownVlat = field(default_factory=lambda: _f(0.0))
    touchdown_tilt: TouchdownTilt = field(default_factory=lambda: _f(0.0))
    miss_distance: MissDistance = field(default_factory=lambda: _f(-1.0))


# --- guidance (flight software in the tick: phase ladder, pointing, engines) --


IIP_STEPS = 24
IIP_CD_S_M2 = 24.0  # FSW's engines-first drag estimate (CA_DESCENT * S_ref + fins)
# Earth rotation in the pad-ENU basis: the predictor integrates the same
# rotating-frame equations of motion as the plant.
_OMEGA_ENU = OMEGA_EARTH_RADPS * np.array(
    [float(_E_HAT[2]), float(_N_HAT[2]), float(_U_HAT[2])]
)
_G_APPARENT = G0 - OMEGA_EARTH_RADPS**2 * _R_PAD_SURFACE * float(
    np.cos(np.radians(PAD_LAT_DEG)) ** 2
)
_CENTER = np.array([0.0, 0.0, _R_PAD_SURFACE])


def _impact_point(r_enu, v_enu, mass, cd_s=IIP_CD_S_M2, wind_enu=None):
    """Drag-aware rotating-frame ballistic impact point (pad-ENU xy), by
    ``IIP_STEPS`` Heun (RK2) steps with a wind-relative drag estimate
    (the JAX example's ``lax.scan`` as a Python loop).  This is the
    campaign's hottest loop: 24 steps of ~25 ops on every guidance tick."""
    h0 = torch.clamp(r_enu[2], min=1.0)
    vz0 = v_enu[2]
    t_vac = (vz0 + torch.sqrt(vz0 * vz0 + 2.0 * G0 * h0)) / G0
    dt = torch.clamp(1.35 * t_vac, 8.0, 430.0) / IIP_STEPS
    omega = const(_OMEGA_ENU, r_enu)
    center = const(_CENTER, r_enu)

    def accel(r, v):
        h = torch.clamp(r[2], min=0.0)
        v_air = v if wind_enu is None else v - wind_enu
        speed = _norm(v_air) + 1e-9
        rho = 1.225 * torch.exp(-h / 8_500.0)
        to_center = -(r + center)
        g_h = _G_APPARENT * (_R_PAD_SURFACE / (_R_PAD_SURFACE + h)) ** 2
        return (g_h * to_center / torch.clamp(_norm(to_center), min=1.0)
                - 2.0 * _cross(omega, v)
                - 0.5 * rho * speed * v_air * (cd_s / mass))

    r, v, done = r_enu, v_enu, r_enu[2] <= 0.0
    for _ in range(IIP_STEPS):
        a1 = accel(r, v)
        a2 = accel(r + v * dt, v + a1 * dt)
        v_n = v + 0.5 * (a1 + a2) * dt
        r_n = r + 0.5 * (v + v_n) * dt
        crossing = (~done) & (r_n[2] <= 0.0)
        # interpolate the ground crossing within the step
        dz = torch.clamp(r_n[2] - r[2], max=-1e-9)
        frac = torch.where(crossing, r_n[2] / dz, 0.0)
        r_c = r_n - (r_n - r) * frac
        r = torch.where(done, r, torch.where(crossing, r_c, r_n))
        v = torch.where(done, v, v_n)
        done = done | crossing
    return r[:2]


@el.system
def guidance(
    tick: el.Query[el.SimulationTick],
    ts: el.Query[el.SimulationTimeStep],
    q: el.Query[
        el.WorldPos, el.WorldVel, Prop, Phase, DryMass, ThrustDir, CgStation, CdDescent,
        Wind, LandSingle, LandCommit, MecoT,
    ],
) -> el.Query[Phase, Throttle, EngineCmd, ThrustDir, EnginesLit, LandSingle, LandCommit, MecoT]:
    t = tick[0] * ts[0]

    def one(pos, vel, prop, phase, dry, prev_dir, cg, cd_desc, wind_c, land_single,
            land_commit, meco_t):
        r = pos.linear()
        v = vel.linear()
        r_enu = to_enu(r)
        v_enu = vec_enu(v)
        h = altitude_m(r)
        speed = _norm(v) + 1e-9
        up = const(_UP, r)
        lz1_xy = const(_LZ1_XY, r)
        sep_done = (meco_t >= 0.0) & (t >= meco_t + SEP_DELAY_S)
        m_now = dry + prop + torch.where(sep_done, 0.0,
                                         torch.full_like(prop, STAGE2_AND_PAYLOAD_KG))
        vz = v_enu[2]
        vdown = -vz
        # engine-plane height above the LZ-1 deck
        h_e = torch.clamp(r_enu[2] - _LZ1_Z - cg, min=0.5)
        p_amb = atmosphere.pressure(torch.clamp(h, min=0.0))
        t_eng_max = prop_mod.engine_thrust_per_engine(1.0, p_amb)
        t_eng_min = prop_mod.engine_thrust_per_engine(THROTTLE_MIN, p_amb)

        # -- phase transitions (monotone ladder) --------------------------
        fsw_cd = IIP_CD_S_M2 * cd_desc / CD_DESCENT_NOMINAL
        impact_xy = _impact_point(r_enu, v_enu, dry + prop, fsw_cd, wind_c)
        iip_err = lz1_xy - impact_xy
        ret_dir = lz1_xy - r_enu[:2]
        ret_dir = ret_dir / (_norm(ret_dir) + 1e-6)
        aim_xy = lz1_xy + BOOSTBACK_AIM_BIAS_M * ret_dir
        bb_err = aim_xy - impact_xy
        bb_done = _norm(bb_err) < 1_000.0
        # hoverslam ignition on the single-engine finishing profile
        a_land3 = 0.70 * torch.clamp(3.0 * t_eng_max / m_now - G0, min=0.5)
        h_eff = torch.clamp(
            h_e - LANDING_SPOOL_CHARGE_S * torch.clamp(vdown, min=0.0) - 20.0, min=1.0)
        v_profile = torch.sqrt(2.0 * a_land3 * h_eff)
        want_landing = ((vdown > 5.0) & (h_e < LANDING_ARM_ALT_M)
                        & (vdown * LANDING_IGNITION_MARGIN >= v_profile))

        # flip completion gate for the boostback light
        x_body = pos.angular() @ const(_X_HAT, r)
        att_err_prev = torch.arccos(
            torch.clamp(_dot(x_body, prev_dir / (_norm(prev_dir) + 1e-9)), -1.0, 1.0))

        meco_now = (phase == ASCENT) & (
            ((t >= T_MECO_MIN_S) & (prop <= MECO_RESERVE_KG)) | (t >= T_MECO_MAX_S))
        meco_t = torch.where(meco_now & (meco_t < 0.0), t, meco_t)
        phase = torch.where(meco_now, FLIP, phase)
        bb_window = (meco_t >= 0.0) & (t >= meco_t + SEP_DELAY_S + FLIP_MIN_S)
        phase = torch.where(
            (phase == FLIP) & bb_window & (att_err_prev < BOOSTBACK_ATT_GATE_RAD),
            BOOSTBACK, phase)
        # hard timeout: the burn's TVC corrects any residual flip error
        phase = torch.where(
            (phase == FLIP) & (meco_t >= 0.0) & (t >= meco_t + FLIP_TIMEOUT_S),
            BOOSTBACK, phase)
        phase = torch.where((phase == BOOSTBACK) & bb_done, COAST, phase)
        phase = torch.where((phase == COAST) & (h < ENTRY_BURN_ALT_M) & (vz < 0), ENTRY, phase)
        phase = torch.where((phase == ENTRY) & (speed < ENTRY_BURN_EXIT_SPEED_MPS),
                            DESCENT, phase)
        phase = torch.where((phase == DESCENT) & want_landing, LANDING, phase)

        # -- pointing commands -------------------------------------------
        pitch = _PITCH_KICK_RAD * torch.clamp((t - T_PITCH_START_S) / 8.0, 0.0, 1.0)
        kick = up * torch.cos(pitch) + const(_DOWNRANGE, r) * torch.sin(pitch)
        v_unit_enu = v_enu / speed
        ascent_dir = torch.where(speed > 120.0, v_unit_enu, kick)

        bb_dir_xy = bb_err / (_norm(bb_err) + 1e-6)
        boostback_dir = torch.nn.functional.pad(bb_dir_xy, (0, 1), value=-0.10)
        boostback_dir = boostback_dir / _norm(boostback_dir)

        retro = -v_unit_enu

        # entry-burn powered divert toward the IIP error
        iip_n = _norm(iip_err) + 1e-6
        steer_vec = torch.nn.functional.pad(iip_err / iip_n, (0, 1), value=0.0)
        entry_steer = torch.clamp(iip_n / 2000.0, 0.0, 1.0) * ENTRY_STEER_MAX_RAD
        entry_dir = retro + entry_steer * steer_vec
        entry_dir = entry_dir / _norm(entry_dir)

        # descent steering: tilt the retro attitude toward the IIP error
        steer = torch.clamp(iip_n / 1500.0, 0.0, 1.0) * STEER_TILT_MAX_RAD
        descent_dir = retro + steer * steer_vec
        descent_dir = descent_dir / _norm(descent_dir)

        # -- landing burn: vertical rate loop on the suicide curve, ZEM/ZEV
        # lateral ------------------------------------------------------
        h_land = torch.clamp(h_e - 2.0, min=0.0)
        a_floor = torch.clamp(t_eng_min / m_now - G0, min=0.5)
        a_single = torch.clamp(t_eng_max / m_now - G0, min=0.6)
        a_mid = a_floor + 0.35 * (a_single - a_floor)
        v_single = torch.sqrt(2.0 * a_mid * h_land)
        # hand over early by the outer pair's spool-down tail
        spool_tail = 2.0 * t_eng_min * ENGINE_SHUTDOWN_TAU_S / torch.clamp(m_now, min=1.0)
        go_single = vdown <= v_single + spool_tail
        land_single = torch.where((phase == LANDING) & go_single, 1.0, land_single)
        on_single = land_single > 0.5
        a_land = torch.where(on_single, a_mid, a_land3)
        v_des = torch.sqrt(2.0 * a_land * h_land) + zemzev.V_TD_MPS
        # lateral-cleanup hold near the deck
        vlat_now = _norm(v_enu[:2])
        cleanup = (h_e < 60.0) & (vlat_now > 0.7)
        v_des = torch.where(
            cleanup, v_des * torch.clamp(1.0 - (vlat_now - 0.7) / 6.0, 0.25, 1.0), v_des)
        kv = torch.where(h_e < 200.0, LANDING_KV_LOW, torch.full_like(h_e, LANDING_KV_HIGH))
        a_up = torch.clamp(G0 + a_land + kv * (vdown - v_des), min=0.0)

        p_rel = r_enu - const(_LZ1_ENU, r) - cg * up
        t_go, t_raw = zemzev.t_go_hoverslam(h_e, vdown)
        miss_h = _norm(p_rel[:2])
        commit_gate = (h_e < zemzev.COMMIT_ALT_M) | (
            (t_raw > 0.0) & (t_raw < zemzev.COMMIT_TGO_S) & (h_e < 200.0))
        commit_now = commit_gate & ((miss_h < COMMIT_MISS_MAX_M) | (h_e < 25.0))
        land_commit = torch.where((phase == LANDING) & commit_now, 1.0, land_commit)
        committed = land_commit > 0.5
        tilt_cap = torch.where(h_e > 100.0, 0.35, torch.full_like(h_e, zemzev.TILT_CAP_RAD))
        max_lat = torch.clamp(a_up, min=G0) * torch.tan(tilt_cap)
        a_zem = zemzev.accel_cmd(p_rel, v_enu, up, t_go, committed)
        a_lat3 = a_zem - _dot(a_zem, up) * up

        # post-commit: damp the lateral velocity within a tapering tilt budget
        one_minus_up = const(_ONE_MINUS_UP, r)
        a_damp = -LANDING_KLAT_POST * v_enu * one_minus_up
        damp_cap = torch.maximum(
            _TAN_1_DEG * torch.clamp(a_up, min=G0),
            max_lat * torch.clamp((h_e - 4.0) / 21.0, 0.0, 1.0))
        damp_cap = torch.where(cleanup & (h_e > 12.0), max_lat, damp_cap)
        a_damp = a_damp * torch.clamp(damp_cap / torch.clamp(_norm(a_damp), min=1e-6), max=1.0)
        # post-commit position recovery with the budget left after damping
        k_pos_post = 0.05 * torch.clamp((h_e - 12.0) / 30.0, 0.0, 1.0)
        chase_budget = torch.sqrt(torch.clamp(damp_cap**2 - _norm(a_damp) ** 2, min=0.0))
        a_chase = -k_pos_post * p_rel * one_minus_up
        a_chase = a_chase * torch.clamp(
            chase_budget / torch.clamp(_norm(a_chase), min=1e-6), max=1.0)
        a_damp = a_damp + a_chase
        a_lat3 = torch.where(committed, a_damp, a_lat3)
        lat_mag = _norm(a_lat3)
        a_lat = a_lat3 * torch.clamp(max_lat / torch.clamp(lat_mag, min=1e-6), max=1.0)
        a_cmd = torch.clamp(a_up, min=G0) * up + a_lat
        landing_dir = a_cmd / torch.clamp(_norm(a_cmd), min=1e-6)

        # engine count from the required thrust, de-escalating monotonically
        cos_tilt = torch.clamp(_dot(vec_enu(x_body), up), min=0.6)
        three = ~on_single
        n_land = torch.where(three, 3.0, torch.ones_like(h_e))
        landing_throttle = torch.clamp(
            (m_now * a_up / cos_tilt / n_land + p_amb * ENGINE_A_E_M2) / ENGINE_T_VAC_N,
            THROTTLE_MIN, 1.0)
        # min-throttle lofting guard and terminal cutoff near the deck
        lofting = (phase == LANDING) & (h_e < 150.0) & (vdown < 0.5)
        lofting = lofting | ((phase == LANDING) & (h_e < 0.45) & (vdown < 1.8))

        dir_enu = _select(
            [phase == ASCENT, phase == FLIP, phase == BOOSTBACK, phase == COAST,
             phase == ENTRY, phase == DESCENT, phase == LANDING],
            [ascent_dir, boostback_dir, boostback_dir, retro, entry_dir, descent_dir,
             landing_dir],
            up)
        # ascent throttle shaping: Max-Q bucket and the acceleration limit
        qbar_now = 0.5 * atmosphere.density(torch.clamp(h, min=0.0)) * speed**2
        bucket = (qbar_now > BUCKET_Q_ON_PA) & (speed < 500.0)
        asc_throttle = torch.where(bucket, BUCKET_THROTTLE, torch.ones_like(h))
        u_g_limit = ASCENT_G_LIMIT * m_now / torch.clamp(N_ENGINES * t_eng_max, min=1.0)
        asc_throttle = torch.clamp(torch.minimum(asc_throttle, u_g_limit), THROTTLE_MIN, 1.0)
        zero = torch.zeros_like(h)
        throttle = _select(
            [phase == ASCENT, phase == BOOSTBACK, phase == ENTRY, phase == LANDING],
            [asc_throttle, BOOSTBACK_THROTTLE, ENTRY_THROTTLE, landing_throttle],
            zero)
        mask_trio = const(MASK_TRIO, r)
        landing_mask = torch.where(three, mask_trio, const(MASK_CENTER, r))
        landing_mask = torch.where(lofting, 0.0, landing_mask)
        engine_cmd = _select(
            [phase == ASCENT, phase == BOOSTBACK, phase == ENTRY, phase == LANDING],
            [const(MASK_ALL, r), mask_trio, mask_trio, landing_mask],
            torch.zeros_like(landing_mask))
        out_of_prop = prop <= 0.0
        throttle = torch.where(out_of_prop, 0.0, throttle)
        engine_cmd = torch.where(out_of_prop, 0.0, engine_cmd)
        return (phase, throttle, engine_cmd, from_enu_dir(dir_enu), engine_cmd.sum(-1),
                land_single, land_commit, meco_t)

    return q.map(
        (Phase, Throttle, EngineCmd, ThrustDir, EnginesLit, LandSingle, LandCommit, MecoT),
        one)


# --- propulsion plant --------------------------------------------------------


@el.system
def engine_dynamics(
    ts: el.Query[el.SimulationTimeStep],
    q: el.Query[el.WorldPos, EngineCmd, Throttle, EngineSpool, EngineLitState,
                TeatebCharges, Prop, ThrustEff, Phase],
) -> el.Query[EngineSpool, EngineLitState, TeatebCharges, ThrustTotal, Prop]:
    """Per-engine spool with ignition gating: a dark engine lights only
    while TEA-TEB charges remain (one per light); spin-up is slow from cold,
    throttle response fast once running."""
    dt = ts[0]

    def one(pos, cmd, throttle, spool, lit, charges, prop, eff, phase):
        want = cmd > 0.5
        cold = (lit < 0.5) & (spool < 0.5 * THROTTLE_MIN)
        can_light = charges > 0.5
        lighting = want & cold & can_light
        lit_new = torch.where(want, torch.where(cold, can_light.to(spool.dtype), 1.0), 0.0)
        charges = charges - lighting.to(spool.dtype)

        # dry tanks make no thrust
        has_prop = prop > 0.0
        target = lit_new * torch.clamp(throttle, THROTTLE_MIN, 1.0)
        target = torch.where(has_prop, target, 0.0)
        running = spool > 0.5 * THROTTLE_MIN
        tau_up = torch.where(running, ENGINE_THROTTLE_TAU_S,
                             torch.full_like(spool, ENGINE_SPINUP_TAU_S))
        tau = torch.where(target > spool, tau_up, ENGINE_SHUTDOWN_TAU_S)
        spool = spool + (1.0 - torch.exp(-dt / tau)) * (target - spool)
        spool = torch.where(spool < 1e-3, 0.0, spool)

        h = altitude_m(pos.linear())
        p_amb = atmosphere.pressure(torch.clamp(h, min=0.0))
        thrust = eff * torch.sum(prop_mod.engine_thrust_per_engine(spool, p_amb), dim=-1)
        thrust = torch.where(has_prop, thrust, 0.0)
        mdot = torch.sum(prop_mod.cluster_mdot(1.0, spool), dim=-1)
        prop_new = torch.clamp(prop - mdot * dt, min=0.0)
        thrust = torch.where(phase == DOWN, 0.0, thrust)
        return spool, lit_new, charges, thrust, prop_new

    return q.map((EngineSpool, EngineLitState, TeatebCharges, ThrustTotal, Prop), one)


@el.system
def tank_dynamics(
    ts: el.Query[el.SimulationTimeStep],
    q: el.Query[TankPressure, Prop, EngineSpool, ThrustTotal, el.Inertia],
) -> el.Query[TankPressure, InletPressure]:
    """Isothermal ullage with helium infill while any engine runs; the inlet
    adds the acceleration head."""
    dt = ts[0]

    def one(p_tank, prop, spool, thrust, inertia):
        m_lox, m_rp1 = lox_rp1(prop)
        mdot = torch.sum(prop_mod.cluster_mdot(1.0, spool), dim=-1)
        mdot_lox, mdot_rp1 = prop_mod.split_mdot(mdot)
        infill = torch.where(torch.sum(spool, dim=-1) > 1e-3, 1.0, torch.zeros_like(prop))
        p_lox = prop_mod.tank_pressure_step(
            p_tank[0], m_lox, mdot_lox, prop_mod.V_TANK_LOX_M3, prop_mod.RHO_LOX,
            infill, 0.0, dt)
        p_rp1 = prop_mod.tank_pressure_step(
            p_tank[1], m_rp1, mdot_rp1, prop_mod.V_TANK_RP1_M3, prop_mod.RHO_RP1,
            infill, 0.0, dt)
        # full stack mass (stage 2 and payload until separation)
        a_axial = thrust / torch.clamp(inertia.mass(), min=1.0)
        inlet = torch.stack([
            prop_mod.inlet_pressure(p_lox, m_lox, prop_mod.RHO_LOX,
                                    prop_mod.LOX_TANK_BOTTOM_M, a_axial, mdot_lox),
            prop_mod.inlet_pressure(p_rp1, m_rp1, prop_mod.RHO_RP1,
                                    prop_mod.RP1_TANK_BOTTOM_M, a_axial, mdot_rp1),
        ])
        return torch.stack([p_lox, p_rp1]), inlet

    return q.map((TankPressure, InletPressure), one)


@el.system
def mass_props(
    tick: el.Query[el.SimulationTick],
    ts: el.Query[el.SimulationTimeStep],
    q: el.Query[Prop, DryMass, MecoT],
) -> el.Query[el.Inertia, CgStation]:
    """Cylinder-stack mass properties each tick; the dispersed dry mass
    shifts the dry element, the stations stay nominal."""
    t = tick[0] * ts[0]

    def one(prop, dry, meco_t):
        m_lox, m_rp1 = lox_rp1(prop)
        sep_done = (meco_t >= 0.0) & (t >= meco_t + SEP_DELAY_S)
        m_upper = torch.where(sep_done, 0.0, torch.full_like(prop, STAGE2_AND_PAYLOAD_KG))
        mass, cg, i_diag = prop_mod.stack_mass_props(m_lox, m_rp1, m_upper)
        mass = mass + (dry - STAGE1_DRY_MASS_KG)
        return el.SpatialInertia(mass=mass, inertia=i_diag), cg

    return q.map((el.Inertia, CgStation), one)


# --- attitude inner loop -----------------------------------------------------


@el.map
def airdata(pos: el.WorldPos, vel: el.WorldVel, wind: Wind) -> tuple[Qbar, MachNum]:
    h = torch.clamp(altitude_m(pos.linear()), min=0.0)
    v_air = vel.linear() - from_enu_dir(wind)
    speed = _norm(v_air)
    return (0.5 * atmosphere.density(h) * speed * speed,
            speed / atmosphere.speed_of_sound(h))


@el.map
def attitude_control(
    pos: el.WorldPos,
    vel: el.WorldVel,
    tdir: ThrustDir,
    phase: Phase,
    inertia: el.Inertia,
    thrust: ThrustTotal,
    cg: CgStation,
    qbar: Qbar,
    mach: MachNum,
    wind: Wind,
) -> tuple[TvcCmd, FinCmd, RcsCmd]:
    """Inertia-scaled quaternion-error PD with phase-scheduled bandwidth,
    allocated to TVC (powered pitch/yaw), grid fins (aero descent) and the
    RCS (roll always; everything unpowered)."""
    q = pos.angular()
    q_inv = q.inverse()
    x_body = q @ const(_X_HAT, tdir)
    d = tdir / (_norm(tdir) + 1e-9)
    axis_w = _cross(x_body, d)
    s = _norm(axis_w)
    ang = torch.atan2(s, torch.clamp(_dot(x_body, d), -1.0, 1.0))
    axis_w = torch.where(s > 1e-8, axis_w / (s + 1e-12), 0.0)
    err_body = q_inv @ (axis_w * ang)
    omega_body = q_inv @ vel.angular()
    i_diag = inertia.inertia_diag()

    landing = phase == LANDING
    tvc_on = thrust > TVC_THRUST_MIN_N
    # authority-aware bandwidth: keep the PD's stiffness inside the gimbal
    tau_max = TVC_MAX_RAD * torch.clamp(cg * thrust, min=1.0)
    i_tr = torch.maximum(inertia.inertia_diag()[1], inertia.inertia_diag()[2])
    wn_auth = torch.sqrt(tau_max / (i_tr * torch.clamp(ang, min=0.05)))
    wn_land = torch.clamp(wn_auth, max=ATT_WN_TVC_LANDING)
    wn = torch.where(tvc_on, torch.where(landing, wn_land, ATT_WN_TVC), ATT_WN_RCS)
    zeta = torch.where(tvc_on, ATT_ZETA_TVC, torch.full_like(thrust, ATT_ZETA_RCS))
    # no roll reference (axisymmetric): damp roll rate only
    err_vec = err_body * const(_ROLL_FREE, tdir)
    torque_des = i_diag * (wn**2 * err_vec - 2.0 * zeta * wn * omega_body)

    # TVC: lateral thrust fractions (dy, dz); tau = (0, T cg dz, -T cg dy)
    lever = torch.clamp(cg * thrust, min=1.0)
    tvc_cmd = torch.where(
        tvc_on, torch.stack([-torque_des[2] / lever, torque_des[1] / lever]), 0.0)
    tvc_cmd = torch.clamp(tvc_cmd, -TVC_MAX_RAD, TVC_MAX_RAD)
    tvc_torque = torch.stack([0.0 * lever, lever * tvc_cmd[1], -lever * tvc_cmd[0]])

    # grid fins pick up what the TVC doesn't, once there is dynamic pressure
    fins_on = (~tvc_on) & (qbar > FIN_Q_MIN_PA) & (phase >= ENTRY)
    resid = torque_des - torch.where(tvc_on, tvc_torque, 0.0)
    auth = aero.fin_torque_authority(mach, torch.clamp(qbar, min=1.0), cg)
    # trim feedforward against the static aero restoring moment
    v_air_body = q_inv @ (vel.linear() - from_enu_dir(wind))
    _, tau_static = aero.body_aero_wrench(
        v_air_body, mach, qbar, cg, omega_body=torch.zeros_like(v_air_body))
    resid = resid - torch.where(fins_on, tau_static, 0.0)
    pyr_cmd = torch.stack([
        resid[1] / torch.clamp(auth[1], min=1.0),  # pitch
        resid[2] / torch.clamp(auth[2], min=1.0),  # yaw
        resid[0] / torch.clamp(auth[0], min=1.0),  # roll
    ])
    pyr_cmd = torch.clamp(pyr_cmd, -FIN_MAX_RAD, FIN_MAX_RAD)
    fin_cmd = torch.where(fins_on, aero.fin_mix(pyr_cmd), 0.0)

    # RCS: roll when powered, everything unpowered in thin air; off while
    # the fins own attitude
    resid_rcs = torch.where(
        tvc_on, torch.stack([torque_des[0], 0.0 * lever, 0.0 * lever]), resid)
    in_deadband = (_norm(err_vec) < RCS_DEADBAND_ATT_RAD) & (
        _norm(omega_body) < RCS_DEADBAND_RATE_RADPS)
    rcs_cmd = torch.where(in_deadband | fins_on | (phase == DOWN), 0.0,
                          rcs_mod.allocate_torque(resid_rcs, cg))
    return tvc_cmd, fin_cmd, rcs_cmd


@el.system
def actuators(
    ts: el.Query[el.SimulationTimeStep],
    q: el.Query[TvcCmd, TvcState, FinCmd, FinState, RcsCmd, RcsState],
) -> el.Query[TvcState, FinState, RcsState]:
    """Rate-limited first-order actuators."""
    dt = ts[0]

    def one(tvc_cmd, tvc, fin_cmd, fin, rcs_cmd, rcs):
        return (
            prop_mod.actuator_step(tvc, tvc_cmd, dt, TVC_TAU_S, TVC_RATE_RADPS,
                                   -TVC_MAX_RAD, TVC_MAX_RAD),
            prop_mod.actuator_step(fin, fin_cmd, dt, FIN_TAU_S, FIN_RATE_RADPS,
                                   -FIN_MAX_RAD, FIN_MAX_RAD),
            prop_mod.actuator_step(rcs, rcs_cmd, dt, RCS_VALVE_TAU_S, lo=0.0, hi=1.0),
        )

    return q.map((TvcState, FinState, RcsState), one)


# --- effectors (forces + torques) --------------------------------------------


@el.map
def effectors(
    pos: el.WorldPos,
    vel: el.WorldVel,
    inertia: el.Inertia,
    phase: Phase,
    thrust: ThrustTotal,
    tvc: TvcState,
    fin: FinState,
    rcs_lv: RcsState,
    wind: Wind,
    cd_desc: CdDescent,
    cg: CgStation,
    qbar: Qbar,
    mach: MachNum,
    f: el.Force,
) -> tuple[el.Force, SpecForceBody]:
    """Rotating-ECEF forces: gravity and frame pseudo-forces (world), thrust,
    body aero, grid fins and RCS (body wrenches rotated out)."""
    r = pos.linear()
    v = vel.linear()
    m = inertia.mass()
    q = pos.angular()
    q_inv = q.inverse()

    g = -MU_EARTH_M3S2 * r / _norm(r) ** 3
    w_e = const(_W_EARTH, r)
    frame_acc = -_cross(w_e, _cross(w_e, r)) - 2.0 * _cross(w_e, v)

    v_air_world = v - from_enu_dir(wind)
    v_air_body = q_inv @ v_air_world
    omega_body = q_inv @ vel.angular()

    # thrust along the gimballed engine axis, applied at the engine plane
    t_dir_body = torch.stack([1.0 - 0.5 * (tvc[0] ** 2 + tvc[1] ** 2), tvc[0], tvc[1]])
    f_thrust = thrust * t_dir_body
    tau_thrust = _cross(const(_MINUS_X_HAT, r) * cg, f_thrust)

    # body aero from the Mach tables, erased by plume dominance
    kappa = aero.plume_dominance(thrust, qbar)
    blend = aero.config_blend(v_air_body[0])
    ca_scale = blend + (1.0 - blend) * (cd_desc / CD_DESCENT_NOMINAL)
    f_aero, tau_aero = aero.body_aero_wrench(
        v_air_body, mach, qbar, cg, omega_body=omega_body, ca_scale=ca_scale)
    f_fin, tau_fin = aero.fin_wrench(fin, mach, qbar, cg)
    f_aero = (1.0 - kappa) * f_aero
    tau_aero = (1.0 - kappa) * tau_aero

    f_rcs, tau_rcs = rcs_mod.rcs_wrench(rcs_lv, cg)

    f_body = f_thrust + f_aero + f_fin + f_rcs
    tau_body = tau_thrust + tau_aero + tau_fin + tau_rcs

    down = phase == DOWN
    force_w = torch.where(down, 0.0, m * (g + frame_acc) + (q @ f_body))
    torque_w = torch.where(down, 0.0, q @ tau_body)
    spec_force = torch.where(down, 0.0, f_body / m)
    return (el.SpatialForce(torque=f.torque() + torque_w, linear=f.force() + force_w),
            spec_force)


# --- sensors -----------------------------------------------------------------


@el.system
def sensor_suite(
    tick: el.Query[el.SimulationTick],
    ts: el.Query[el.SimulationTimeStep],
    q: el.Query[
        el.WorldPos, el.WorldVel, SpecForceBody, MachNum, ThrustTotal, TankPressure,
        InletPressure, sn.GpsTimer, sn.GpsPos, sn.GpsVel, sn.GpsCount, sn.RadarTimer,
        sn.RadarRange, sn.RadarCount,
    ],
) -> el.Query[
    sn.ImuAccel, sn.ImuGyro, sn.GpsTimer, sn.GpsPos, sn.GpsVel, sn.GpsCount,
    sn.RadarTimer, sn.RadarRange, sn.RadarCount, sn.PressureMeas, sn.DisplaySpeed,
    sn.DisplayAlt,
]:
    """IMU at the physics rate; GPS and radar on a timer accumulator with
    hold and sample counters; GPS blackout in the retropropulsion plasma.
    The six noise draws of a tick are made together, before use."""
    dt = ts[0]
    k = tick[0]

    def one(pos, vel, sf_body, mach, thrust, tank_p, inlet_p,
            gps_timer, gps_pos, gps_vel, gps_count,
            radar_timer, radar_range, radar_count):
        q = pos.angular()
        r_enu = to_enu(pos.linear())
        v_enu = vec_enu(vel.linear())
        omega_body = q.inverse() @ vel.angular()
        next_count = gps_count + 1.0
        next_rcount = radar_count + 1.0
        n_accel, n_gyro, n_gps_pos, n_gps_vel, n_radar, n_pressure = sn.noise_streams([
            (k, 1, (3,), sn.IMU_ACCEL_SIGMA),
            (k, 2, (3,), sn.IMU_GYRO_SIGMA),
            (next_count, 3, (3,), sn.GPS_POS_SIGMA),
            (next_count, 4, (3,), sn.GPS_VEL_SIGMA),
            (next_rcount, 5, (), sn.RADAR_SIGMA_M),
            (k, 6, (4,), sn.PRESSURE_SIGMA_PA),
        ])

        imu_accel = sf_body + n_accel
        w_earth_body = q.inverse() @ const(_W_EARTH, r_enu)
        imu_gyro = omega_body + w_earth_body + n_gyro

        # GPS: 25 Hz sample and hold, blacked out in hot retropropulsion
        gps_timer = gps_timer + dt
        gps_due = gps_timer >= 1.0 / sn.GPS_RATE_HZ
        blackout = (mach > sn.BLACKOUT_MACH_MIN) & (thrust > sn.BLACKOUT_THRUST_MIN_N)
        gps_fire = gps_due & ~blackout
        gps_timer = torch.where(gps_due, gps_timer - 1.0 / sn.GPS_RATE_HZ, gps_timer)
        gps_pos = torch.where(gps_fire, r_enu + n_gps_pos, gps_pos)
        gps_vel = torch.where(gps_fire, v_enu + n_gps_vel, gps_vel)
        gps_count = torch.where(gps_fire, next_count, gps_count)

        # radar altimeter along -X (engines first), gated by FOV and range
        radar_timer = radar_timer + dt
        radar_due = radar_timer >= 1.0 / sn.RADAR_RATE_HZ
        radar_timer = torch.where(radar_due, radar_timer - 1.0 / sn.RADAR_RATE_HZ, radar_timer)
        boresight = q @ const(_RADAR_BORESIGHT, r_enu)
        cos_down = _dot(boresight, -const(_U_HAT, r_enu))
        h = torch.clamp(r_enu[2], min=0.0)
        slant = h / torch.clamp(cos_down, min=1e-3)
        visible = (cos_down > sn.RADAR_FOV_COS) & (slant < sn.RADAR_MAX_RANGE_M)
        meas = slant + n_radar
        radar_range = torch.where(radar_due, torch.where(visible, meas, -1.0), radar_range)
        radar_count = torch.where(radar_due & visible, next_rcount, radar_count)

        pressure = torch.cat([tank_p, inlet_p]) + n_pressure

        speed = _norm(v_enu)
        disp_speed = torch.round(speed / sn.DISPLAY_SPEED_STEP) * sn.DISPLAY_SPEED_STEP
        disp_alt = torch.round(r_enu[2] / sn.DISPLAY_ALT_STEP) * sn.DISPLAY_ALT_STEP
        return (imu_accel, imu_gyro, gps_timer, gps_pos, gps_vel, gps_count,
                radar_timer, radar_range, radar_count, pressure, disp_speed, disp_alt)

    return q.map(
        (sn.ImuAccel, sn.ImuGyro, sn.GpsTimer, sn.GpsPos, sn.GpsVel, sn.GpsCount,
         sn.RadarTimer, sn.RadarRange, sn.RadarCount, sn.PressureMeas, sn.DisplaySpeed,
         sn.DisplayAlt),
        one)


# --- ground interaction ------------------------------------------------------


@el.map
def contact(
    pos: el.WorldPos,
    vel: el.WorldVel,
    phase: Phase,
    thrust: ThrustTotal,
    inertia: el.Inertia,
    cg: CgStation,
    lifted: Lifted,
    tdvz: TouchdownVz,
    tdvlat: TouchdownVlat,
    tdtilt: TouchdownTilt,
    miss: MissDistance,
) -> tuple[el.WorldPos, el.WorldVel, Phase, Lifted, TouchdownVz, TouchdownVlat,
           TouchdownTilt, MissDistance]:
    """Pad hold-down until thrust exceeds weight; touchdown latch and upright
    pin at the end."""
    r_enu = to_enu(pos.linear())
    v_enu = vec_enu(vel.linear())
    q = pos.angular()
    up_w = const(_U_HAT, r_enu)
    x_body = q @ const(_X_HAT, r_enu)
    tilt = torch.arccos(torch.clamp(_dot(x_body, up_w), -1.0, 1.0))

    m = inertia.mass()
    released = lifted > 0.5
    release_now = (~released) & (thrust > m * G0 * 1.001)
    lifted_new = torch.where(released | release_now, 1.0, torch.zeros_like(lifted))

    # touchdown: the engine plane reaches the LZ-1 deck in terminal descent
    h_e = r_enu[2] - _LZ1_Z - cg * torch.cos(tilt)
    down_now = (phase >= LANDING) & (phase < DOWN) & (h_e <= 0.4) & (v_enu[2] < 1.5)
    was_down = phase == DOWN
    first = down_now & ~was_down
    phase_new = torch.where(down_now | was_down, float(DOWN), phase)

    tdvz_new = torch.where(first, v_enu[2], tdvz)
    tdvlat_new = torch.where(first, _norm(v_enu[:2]), tdvlat)
    tdtilt_new = torch.where(first, torch.rad2deg(tilt), tdtilt)
    miss_new = torch.where(first, _norm(r_enu[:2] - const(_LZ1_XY, r_enu)), miss)

    hold = (~released) & (~release_now)
    frozen = was_down | first | hold
    vel_out = el.SpatialMotion(angular=torch.where(frozen, 0.0, vel.angular()),
                               linear=torch.where(frozen, 0.0, vel.linear()))
    # held down on the pad: re-pin the CG to pad + cg * up every tick
    pad_cg = const(_PAD_ECEF, r_enu) + cg * up_w
    lin_out = torch.where(hold, pad_cg, pos.linear())
    # after touchdown: pin the vertical so the landed booster does not sink
    h_err = (_LZ1_Z + cg * torch.cos(tilt) + 0.4) - r_enu[2]
    lin_out = torch.where(was_down | first, lin_out + h_err * up_w, lin_out)
    return (el.SpatialTransform(angular=q, linear=lin_out), vel_out, phase_new, lifted_new,
            tdvz_new, tdvlat_new, tdtilt_new, miss_new)


# --- build -------------------------------------------------------------------


def build(params=None, sensors: bool = True) -> tuple[el.World, el.System]:
    """The booster's world and the tick's system.  Guidance runs at 20 Hz
    against the 100 Hz plant (``el.every``, holding its commands between
    updates) and at full rate from DESCENT on, in any sample.  With
    ``sensors`` (the default, as in the JAX example) the booster carries a
    ``SensorSuite`` and ``sensor_suite`` runs before ``contact``; no system
    reads the sensors, so the mission is the same without them."""
    p = {k: (params.get(k, v.default) if params else v.default) for k, v in PARAMS.items()}
    w = el.World()
    booster = Booster(
        thrust_eff=_f(p["thrust_eff"]),
        dry_mass=_f(p["dry_mass"]),
        wind=np.array([p["wind_e"], p["wind_n"], 0.0]),
        cd_descent=_f(p["cd_descent"]),
    )
    m0 = p["dry_mass"] + STAGE1_PROP_KG + STAGE2_AND_PAYLOAD_KG
    _, cg0, i0 = prop_mod.stack_mass_props(LOX_LOAD_KG, RP1_LOAD_KG, STAGE2_AND_PAYLOAD_KG)
    body = el.Body(
        world_pos=el.SpatialTransform(
            angular=upright_attitude(),
            linear=torch.as_tensor(_PAD_ECEF + float(cg0) * _U_HAT)),
        world_vel=el.SpatialMotion(),
        inertia=el.SpatialInertia(mass=torch.tensor(m0, dtype=torch.float64), inertia=i0),
    )
    spawn = [body, booster]
    if sensors:
        spawn.append(sn.SensorSuite())
    w.spawn(spawn, name="Booster")
    sys = (
        el.every(GUIDANCE_EVERY_TICKS, guidance,
                 full_rate_when=lambda cols: cols["phase"] >= DESCENT)
        | engine_dynamics
        | tank_dynamics
        | mass_props
        | airdata
        | attitude_control
        | actuators
        | el.six_dof(sys=effectors, integrator=el.Integrator.SemiImplicit)
    )
    if sensors:
        sys = sys | sensor_suite
    sys = sys | contact
    return w, sys
