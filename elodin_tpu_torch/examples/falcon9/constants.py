"""Falcon 9 vehicle + mission configuration (single source of truth).

Parity target: reference examples/falcon9/constants.py — the 2017 CRS-12
Block 3/4 vehicle described by public figures plus EST calibration priors.
Values are data, not code: figures marked EST are public estimates whose
scale factors belong to the Monte-Carlo campaign.
"""

from __future__ import annotations

import math

# --- Earth / WGS84 -----------------------------------------------------------
WGS84_A_M = 6_378_137.0
WGS84_F = 1.0 / 298.257223563
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)
MU_EARTH_M3S2 = 3.986004418e14
OMEGA_EARTH_RADPS = 7.292115e-5
G0 = 9.80665
P_SL_PA = 101_325.0

# --- Sites (CRS-12: LC-39A ascent, LZ-1 landing) -----------------------------
PAD_LAT_DEG, PAD_LON_DEG, PAD_ALT_M = 28.60839, -80.60433, 3.0
LZ1_LAT_DEG, LZ1_LON_DEG, LZ1_ALT_M = 28.48580, -80.54440, 5.0

# --- Stage 1 geometry / mass (EST priors) ------------------------------------
STAGE1_LENGTH_M = 47.0
STAGE1_DIAMETER_M = 3.66
STAGE1_RADIUS_M = STAGE1_DIAMETER_M / 2.0
S_REF_M2 = math.pi * STAGE1_RADIUS_M**2  # ~10.52 m^2
STAGE1_DRY_MASS_KG = 25_600.0
STAGE1_PROP_KG = 398_000.0
OF_RATIO = 2.33  # LOX : RP-1 by mass
LOX_LOAD_KG = STAGE1_PROP_KG * OF_RATIO / (1.0 + OF_RATIO)
RP1_LOAD_KG = STAGE1_PROP_KG - LOX_LOAD_KG
STAGE2_WET_KG = 111_500.0
PAYLOAD_KG = 7_100.0  # Dragon C113 dry + CRS-12 cargo
STAGE2_AND_PAYLOAD_KG = STAGE2_WET_KG + PAYLOAD_KG
LIFTOFF_MASS_KG = STAGE1_DRY_MASS_KG + STAGE1_PROP_KG + STAGE2_AND_PAYLOAD_KG

# --- Merlin 1D cluster (2017 Block 3/4, EST) ---------------------------------
N_ENGINES = 9
ENGINE_T_SL_N = 760e3  # per engine, sea level
ENGINE_A_E_M2 = 0.681  # nozzle exit area (from the published SL/vac pair)
ENGINE_T_VAC_N = ENGINE_T_SL_N + P_SL_PA * ENGINE_A_E_M2  # ~829 kN
ENGINE_ISP_SL_S = 282.0
ENGINE_ISP_VAC_S = ENGINE_ISP_SL_S * ENGINE_T_VAC_N / ENGINE_T_SL_N  # ~308 s
THROTTLE_MIN = 0.57
RELIGHT_CAPABLE_ENGINES = 3  # only the center trio carries extra TEA-TEB
ENGINE_SPINUP_TAU_S = 1.5  # cold turbopump spin-up
ENGINE_THROTTLE_TAU_S = 0.15  # throttle response while running
ENGINE_SHUTDOWN_TAU_S = 0.35

# --- TVC ---------------------------------------------------------------------
TVC_MAX_RAD = math.radians(5.0)
TVC_RATE_RADPS = math.radians(20.0)
TVC_TAU_S = 0.030

# --- Cold-gas RCS (sized by the MECO flip budget) ----------------------------
RCS_THRUST_PER_THRUSTER_N = 7_500.0
RCS_VALVE_TAU_S = 0.007
RCS_STATION_M = 46.0  # interstage pods, m from engine plane

# --- Grid fins ---------------------------------------------------------------
N_GRID_FINS = 4
FIN_MAX_RAD = math.radians(20.0)
FIN_RATE_RADPS = math.radians(20.0)
FIN_TAU_S = 0.050

# --- Tanks -------------------------------------------------------------------
TANK_P_NOM_PA = 3.5e5  # pump-fed ullage setpoint

# --- Touchdown soft-landing envelope -----------------------------------------
TOUCHDOWN_SOFT_VERTICAL_MPS = 2.0
TOUCHDOWN_SOFT_LATERAL_MPS = 1.5
TOUCHDOWN_SOFT_TILT_DEG = 2.0
