"""Test-support harnesses (not imported by the runtime).

`interleave` is the systematic concurrency checker — the repo's analog of
the loom/Miri coverage the reference gets from Rust (SURVEY §5 race
detection): deterministic, replayable thread-interleaving exploration for
the Python-level shared-state protocols (shm SPSC ring, DB storage locks,
pump queues).

A host-only copy of ``elodin_tpu/testing/__init__.py``:
the port imports nothing of the JAX package.
"""

from .interleave import Interleaver, explore  # noqa: F401
