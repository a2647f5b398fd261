from .distributed import init_multihost  # noqa: F401
from .mesh import (  # noqa: F401
    Mesh,
    NamedSharding,
    Sharded,
    entity_sharding,
    make_mesh,
    put_global,
    shard_cols,
    sharded_step,
)
