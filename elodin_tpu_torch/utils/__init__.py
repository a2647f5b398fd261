"""Shared utilities: testing helpers, naming, small numerics (counterpart
of ``elodin_tpu/utils/__init__.py``, over the port's ``dataframe`` and
``entity``)."""

from ..dataframe import DataFrame, Series, assert_frame_equal  # noqa: F401
from ..entity import to_snake_case  # noqa: F401
