from .sixdof_batch import batched_sixdof_init, build_batched_sixdof  # noqa: F401
from .nbody import build_nbody, build_system as build_nbody_system  # noqa: F401,E402
