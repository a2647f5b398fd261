"""Attitude determination and control (counterpart of
``elodin_tpu/adcs``): the MEKF (``mekf``) and the Yang quaternion LQR
(``lqr``).  ``triad``, ``ukf``, ``magical`` and ``magkal`` are not
ported."""

from .lqr import YangLQR, lqr_control_mats, yang_lqr_control  # noqa: F401
from .mekf import Mekf, calculate_covariance  # noqa: F401
