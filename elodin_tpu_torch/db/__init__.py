"""elodin-db: telemetry time-series database + impeller2 protocol.

Python surface mirrors the reference's ``elodin.db`` module
(python/elodin/db.py); the wire protocol mirrors impeller2
(libs/impeller2).  See ``server`` for the TCP database, ``client`` for the
user API, ``storage`` for the store, ``vtable``/``msgs``/``postcard`` for
the codec.

A host-only copy of ``elodin_tpu/db/__init__.py``:
the port imports nothing of the JAX package.
"""

from .client import (  # noqa: F401
    Client,
    ComponentInfo,
    Field,
    Sample,
    Server,
    TableWriter,
    bool_,
    f32,
    f64,
    i8,
    i16,
    i32,
    i64,
    sql_table_name,
    u8,
    u16,
    u32,
    u64,
)
from .mirror import MirrorWorld, SeriesCache, TelemetryCache  # noqa: F401
from .storage import Database  # noqa: F401
from .vtable import component_id_of  # noqa: F401
