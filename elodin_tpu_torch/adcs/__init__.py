"""Attitude determination and control (counterpart of
``elodin_tpu/adcs``): TRIAD (``triad``), the multiplicative EKF
(``mekf``), the Merwe-sigma-point UKF (``ukf``), MAG.I.CAL and the UKF
magnetometer calibration (``magical``, ``magkal``) and the Yang quaternion
LQR (``lqr``)."""

from .triad import triad  # noqa: F401
from .mekf import Mekf, calculate_covariance  # noqa: F401
from .ukf import (  # noqa: F401
    MerweConfig,
    UkfState,
    cross_covar,
    innovate,
    predict,
    unscented_transform,
)
from .lqr import YangLQR, lqr_control_mats, yang_lqr_control  # noqa: F401
from .magical import magical_calibrate  # noqa: F401
from .magkal import MagKal  # noqa: F401
