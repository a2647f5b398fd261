"""The check that a run loaded neither JAX nor the JAX package.

A module counts by its top-level name, the part before the first dot,
compared whole: ``elodin_tpu_torch`` (the measured port) begins with
``elodin_tpu`` (the JAX package), so a prefix test would be wrong.
``elodin`` is the JAX package's alias (``import elodin as el``).
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "elodin_tpu", "elodin"})


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the modules
    this process holds), sorted."""
    names = sys.modules.keys() if names is None else names
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN)
