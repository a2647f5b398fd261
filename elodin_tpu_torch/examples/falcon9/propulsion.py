"""Merlin cluster propulsion, actuators, tank physics and stack mass
properties in torch (counterpart of ``examples/falcon9/propulsion.py``)."""

from __future__ import annotations

import torch

from .._consts import f64
from .constants import (
    ENGINE_A_E_M2,
    ENGINE_ISP_VAC_S,
    ENGINE_T_VAC_N,
    G0,
    LOX_LOAD_KG,
    OF_RATIO,
    RP1_LOAD_KG,
    S_REF_M2,
    STAGE1_DRY_MASS_KG,
    STAGE1_LENGTH_M,
    STAGE1_RADIUS_M,
    TANK_P_NOM_PA,
)

# Stage geometry stations, m above the engine plane (EST).
DRY_CG_STATION_M = 18.8
RP1_TANK_BOTTOM_M = 3.0
LOX_TANK_BOTTOM_M = 17.5
RHO_LOX = 1220.0  # densified
RHO_RP1 = 830.0  # chilled
TANK_AREA_M2 = S_REF_M2
TANK_ULLAGE_FRAC = 0.05
V_TANK_LOX_M3 = (1.0 + TANK_ULLAGE_FRAC) * LOX_LOAD_KG / RHO_LOX
V_TANK_RP1_M3 = (1.0 + TANK_ULLAGE_FRAC) * RP1_LOAD_KG / RHO_RP1

# Attached stage-2 + payload, treated as a cylinder riding above the interstage.
STAGE2_CG_STATION_M = 58.0
STAGE2_LENGTH_M = 16.0

# Helium pressurization (Level-1 ullage model).
P_REGULATOR_PA = TANK_P_NOM_PA + 0.2e5
K_INFILL_PER_S = 0.5
K_VENT_PER_S = 0.3
P_VENT_FLOOR_PA = 1.0e4
K_LINE_PA_PER_KGS2 = 2.0e-2


def engine_thrust_per_engine(throttle, p_ambient_pa):
    """T(u, p_a) = u T_vac - p_a A_e, floored at zero."""
    return torch.clamp(f64(throttle) * ENGINE_T_VAC_N - f64(p_ambient_pa) * ENGINE_A_E_M2,
                       min=0.0)


def cluster_mdot(engines_lit, throttle):
    """Total propellant flow; vacuum-thrust referenced: mdot = T_vac/(Isp g0)."""
    return engines_lit * throttle * ENGINE_T_VAC_N / (ENGINE_ISP_VAC_S * G0)


def split_mdot(mdot_total):
    """(mdot_lox, mdot_rp1) by mixture ratio."""
    lox = mdot_total * (OF_RATIO / (1.0 + OF_RATIO))
    return lox, mdot_total - lox


def actuator_step(x, cmd, dt, tau, rate_limit=None, lo=None, hi=None):
    """One step of a rate-limited first-order actuator: the exact
    discretization x' = x + (1 - e^(-dt/tau))(cmd - x), then the slew and
    travel limits."""
    step = (1.0 - torch.exp(f64(-dt / tau))) * (cmd - x)
    if rate_limit is not None:
        bound = rate_limit * dt
        step = torch.clamp(step, -bound, bound)
    out = x + step
    if lo is not None or hi is not None:
        out = torch.clamp(out, lo, hi)
    return out


def _propellant_column(mass, rho, tank_bottom_m):
    """A propellant column fills from the tank floor and drains top-down.
    Returns (cg station, transverse inertia about its own cg, axial inertia)."""
    height = mass / (rho * TANK_AREA_M2)
    r2 = STAGE1_RADIUS_M**2
    return (
        tank_bottom_m + 0.5 * height,
        mass * (height**2 / 12.0 + 0.25 * r2),
        0.5 * mass * r2,
    )


def stack_mass_props(m_lox, m_rp1, m_upper=0.0):
    """Cylinder-stack mass model: (mass, cg station, [Ix, Iy, Iz] about cg),
    from the dry stage, the LOX and RP-1 columns and the attached upper
    stack, each with a parallel-axis term about the composite CG."""
    m_lox, m_rp1 = f64(m_lox), f64(m_rp1)
    m_upper = m_upper if isinstance(m_upper, torch.Tensor) else torch.full_like(m_lox, m_upper)
    r2 = STAGE1_RADIUS_M**2
    masses = torch.stack([torch.full_like(m_lox, STAGE1_DRY_MASS_KG), m_lox, m_rp1, m_upper])
    cg_lox, it_lox, ia_lox = _propellant_column(m_lox, RHO_LOX, LOX_TANK_BOTTOM_M)
    cg_rp1, it_rp1, ia_rp1 = _propellant_column(m_rp1, RHO_RP1, RP1_TANK_BOTTOM_M)
    stations = torch.stack([torch.full_like(m_lox, DRY_CG_STATION_M), cg_lox, cg_rp1,
                            torch.full_like(m_lox, STAGE2_CG_STATION_M)])
    own_trans = torch.stack([
        torch.full_like(m_lox, STAGE1_DRY_MASS_KG * STAGE1_LENGTH_M**2 / 12.0),
        it_lox, it_rp1, m_upper * STAGE2_LENGTH_M**2 / 12.0])
    own_axial = torch.stack([
        torch.full_like(m_lox, 0.5 * STAGE1_DRY_MASS_KG * r2), ia_lox, ia_rp1,
        0.5 * m_upper * r2])
    total = torch.sum(masses, dim=0)
    cg = torch.sum(masses * stations, dim=0) / total
    i_trans = torch.sum(own_trans + masses * (stations - cg) ** 2, dim=0)
    i_axial = torch.sum(own_axial, dim=0)
    return total, cg, torch.stack([i_axial, i_trans, i_trans], dim=-1)


def tank_pressure_step(p, m_prop, mdot_out, v_tank, rho, infill, vent, dt):
    """Isothermal ullage pressure update: outflow grows the ullage volume,
    the helium infill valve feeds toward the regulator setpoint, the vent
    bleeds toward the ambient floor (``infill``/``vent`` in [0, 1])."""
    v_gas = torch.clamp(v_tank - m_prop / rho, min=1e-2 * v_tank)
    p_after_drain = p * v_gas / (v_gas + mdot_out / rho * dt)
    fill = torch.clamp(K_INFILL_PER_S * (P_REGULATOR_PA - p_after_drain) * infill * dt, min=0.0)
    bleed = torch.clamp(K_VENT_PER_S * (p_after_drain - P_VENT_FLOOR_PA) * vent * dt, min=0.0)
    return torch.clamp(p_after_drain + fill - bleed, min=0.0)


def inlet_pressure(p_tank, m_prop, rho, tank_bottom_m, a_axial_mps2, mdot):
    """Engine-inlet pressure = tank + acceleration head - feedline loss."""
    column_top = tank_bottom_m + m_prop / (rho * TANK_AREA_M2)
    head = rho * torch.clamp(a_axial_mps2, min=0.0) * column_top
    return p_tank + head - K_LINE_PA_PER_KGS2 * mdot**2
