from .mesh import (  # noqa: F401
    Mesh,
    NamedSharding,
    Sharded,
    entity_sharding,
    init_multihost,
    make_mesh,
    put_global,
    shard_cols,
    sharded_step,
)
