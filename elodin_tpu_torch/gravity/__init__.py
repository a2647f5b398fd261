"""Gravity models (counterpart of ``elodin_tpu/gravity``): J2 oblateness
(``j2``) and EGM2008 spherical harmonics (``egm08``)."""

from .j2 import J2  # noqa: F401
from .egm08 import EGM08  # noqa: F401
