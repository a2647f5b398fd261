"""The yardstick's table of peaks and the work each kernel's function needs.

Frozen copies of ``chip_smoke.py``'s published peaks and operation counts,
so that no later change to the program moves the bound it is measured by.
Every count is the function's own work, never the instructions a kernel
happens to issue, so a share reads the same whatever implements it.
"""

from __future__ import annotations

# Published 700 W peaks of one H100 SXM (NVIDIA's data sheet): FP32 and FP64
# outside the tensor cores, and HBM.  The SFU returns 16 results a clock per
# SM, taken at the 1980 MHz boost clock (a traced run prints the clock read
# beside it).
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_HBM = 3.35e12
SFU_PER_SM_CLOCK = 16
BOOST_HZ = 1.98e9

# The 6-dof RK4 rollout, one body-tick, an FMA counted as 2, from the
# algebra of the function (the frame round trip of sixdof_accel cancels,
# R R^T = I, so a stage needs only R e_x and R e_z of its attitude n).
# A stage: |n|^2 7, 2/|n|^2 1, the products 2 n_i/|n|^2 and xy, xz, yz 7, the
# two columns 16, the spin (T m / Izz) R e_z 3, gravity's |p|^2 5 and
# -mu/|r|^3 3, |v|^2 5, the drag's |v| 2 and its factor 1, the linear
# acceleration 15: 65.  Stages 2-4 each add the attitude step 27, the
# position, spin and velocity updates 18 and the RK4 sums 24 (12 at stage
# 4).  The tick's end: the attitude step 27, its normalisation 11, the
# position, spin and velocity 18.  SFU results: a reciprocal and two
# reciprocal square roots a stage, one reciprocal square root at the end.
# In f64 the SFU's seeds are refined to the last bits: 6 operations a
# reciprocal, 8 a reciprocal square root.
SIXDOF_STAGE_OPS = 65
SIXDOF_STEP_OPS = {"attitude": 27, "updates": 18, "rk4_sums": 24}
SIXDOF_END_OPS = {"attitude": 27, "normalise": 11, "updates": 18}
SIXDOF_RCP, SIXDOF_RSQRT = 4 * 1, 4 * 2 + 1
SIXDOF_TICK_SFU = SIXDOF_RCP + SIXDOF_RSQRT
_SIXDOF_F32 = (4 * SIXDOF_STAGE_OPS + 3 * sum(SIXDOF_STEP_OPS.values())
               - SIXDOF_STEP_OPS["rk4_sums"] // 2 + sum(SIXDOF_END_OPS.values()))
SIXDOF_TICK_OPS = {"float32": _SIXDOF_F32,
                   "float64": _SIXDOF_F32 + 6 * SIXDOF_RCP + 8 * SIXDOF_RSQRT}


def bound_s(ops: float, sfu: float, nbytes: float, dtype: str, sm_count: int):
    """(least seconds the card could take, the resource that sets it) for
    ``ops`` operations on the FP32 or FP64 pipe, ``sfu`` SFU results and
    ``nbytes`` read or written once in device memory."""
    times = {"pipe": ops / PEAK_FLOPS[dtype],
             "sfu": sfu / (SFU_PER_SM_CLOCK * sm_count * BOOST_HZ),
             "memory": nbytes / PEAK_HBM}
    resource = max(times, key=times.get)
    return times[resource], resource


def sixdof_rollout_bound_s(bodies: int, ticks: int, dtype: str, sm_count: int):
    """``bound_s`` of one rollout launch: ``bodies`` x ``ticks`` body-ticks,
    the 13 state and 4 parameter values of a body read once and its 13
    state values written once."""
    itemsize = 8 if dtype == "float64" else 4
    body_ticks = bodies * ticks
    return bound_s(body_ticks * SIXDOF_TICK_OPS[dtype], body_ticks * SIXDOF_TICK_SFU,
                   bodies * (13 + 4 + 13) * itemsize, dtype, sm_count)

