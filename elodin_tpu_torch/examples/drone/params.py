"""ArduPilot-convention tuning parameters for the EDU-450 class quad
(counterpart of ``examples/drone/params.py``), as numpy constants.

Acceleration limits are centi-degrees/s^2 and filter cutoffs Hz, as
ArduPilot documents them; ``accel_limits_rad_s2`` converts to SI.
"""

import numpy as np

# Angular acceleration limits (centi-deg/s^2): 10-inch-prop class defaults.
ATC_ACCEL_R_MAX = 110000.0
ATC_ACCEL_P_MAX = 110000.0
ATC_ACCEL_Y_MAX = 27000.0

# Input shaping time constants (s).
ATC_INPUT_TC = 0.15
PILOT_Y_RATE_TC = 0.0

# Rate-PID term filters (Hz): target / error / derivative per axis.
ATC_RAT_RLL_FLTT, ATC_RAT_RLL_FLTE, ATC_RAT_RLL_FLTD = 20.0, 0.0, 10.0
ATC_RAT_PIT_FLTT, ATC_RAT_PIT_FLTE, ATC_RAT_PIT_FLTD = 20.0, 0.0, 10.0
ATC_RAT_YAW_FLTT, ATC_RAT_YAW_FLTE, ATC_RAT_YAW_FLTD = 20.0, 2.5, 0.0

FLTT = np.array([ATC_RAT_RLL_FLTT, ATC_RAT_PIT_FLTT, ATC_RAT_YAW_FLTT])
FLTE = np.array([ATC_RAT_RLL_FLTE, ATC_RAT_PIT_FLTE, ATC_RAT_YAW_FLTE])
FLTD = np.array([ATC_RAT_RLL_FLTD, ATC_RAT_PIT_FLTD, ATC_RAT_YAW_FLTD])


def accel_limits_rad_s2() -> np.ndarray:
    """Body-axis (roll, pitch, yaw) angular-acceleration caps in rad/s^2."""
    cdeg = np.array([ATC_ACCEL_R_MAX, ATC_ACCEL_P_MAX, ATC_ACCEL_Y_MAX])
    return cdeg * 0.01 * np.pi / 180.0
