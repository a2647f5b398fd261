"""Crazyflie 2.1 physical configuration (a copy of
``examples/crazyflie-edu/config.py``, numpy): public Bitcraze figures, 27 g
takeoff mass, 92 mm motor-to-motor diagonal, quad-X layout with the firmware
motor numbering M1 front-left CW .. M4 back-left CCW.
"""

from __future__ import annotations

import numpy as np

MASS_KG = 0.027
ARM_M = 0.092 / 2.0 / np.sqrt(2.0)  # x/y offset of each motor (~32.5 mm)
# slender-plate inertia estimates used by the reference sim
INERTIA = np.array([1.66e-5, 1.66e-5, 2.93e-5])
G0 = 9.81

THRUST_CONSTANT = 9.0e-8  # N/(rad/s)^2
TORQUE_CONSTANT = 9.0e-10  # N*m/(rad/s)^2 (~1% of kf)
MOTOR_TAU_S = 0.02  # first-order rotor spin-up lag
MAX_OMEGA_RADPS = 2500.0

# quad-X motor geometry, firmware numbering (looking down):
#   M1(CW) front-left, M2(CCW) front-right, M3(CW) back-right, M4(CCW) back-left
MOTOR_POS = np.array(
    [
        [ARM_M, ARM_M, 0.0],
        [ARM_M, -ARM_M, 0.0],
        [-ARM_M, -ARM_M, 0.0],
        [-ARM_M, ARM_M, 0.0],
    ]
)
# CW rotors react CCW torque on the body and vice versa
MOTOR_YAW_SIGN = np.array([-1.0, 1.0, -1.0, 1.0])

HOVER_THRUST_PER_MOTOR_N = MASS_KG * G0 / 4.0
HOVER_OMEGA_RADPS = float(np.sqrt(HOVER_THRUST_PER_MOTOR_N / THRUST_CONSTANT))

SIM_RATE_HZ = 500.0  # firmware loop rate
SIM_TIME_STEP = 1.0 / SIM_RATE_HZ


def mixing_matrix() -> np.ndarray:
    """Rows = motors, cols = [roll, pitch, yaw, throttle] factors — how a
    commanded body torque/thrust maps onto per-motor thrust deltas."""
    mix = np.zeros((4, 4))
    for i in range(4):
        # torque about x from thrust f at r is r_y*f; about y it is -r_x*f
        mix[i, 0] = np.sign(MOTOR_POS[i, 1])
        mix[i, 1] = -np.sign(MOTOR_POS[i, 0])
        mix[i, 2] = MOTOR_YAW_SIGN[i]
        mix[i, 3] = 1.0
    return mix
