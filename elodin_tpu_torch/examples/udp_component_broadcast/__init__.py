"""UDP component broadcast (counterpart of
``examples/udp-component-broadcast``): bridges components between two
telemetry databases over UDP as protobuf datagrams.

    python -m elodin_tpu_torch.examples.udp_component_broadcast.broadcast \\
        --db-addr 127.0.0.1:2240 --component bdx.world_pos \\
        --rename target.world_pos --rate 20 --target 192.168.1.255:41235
    python -m elodin_tpu_torch.examples.udp_component_broadcast.receive \\
        --listen 0.0.0.0:41235 --db-addr 127.0.0.1:2240

Both need ``google.protobuf``, which they import when they run, never when
the package is imported.  ``component_broadcast_pb2.py`` is the JAX
example's generated module, copied (regenerate it with
``protoc --python_out=. component_broadcast.proto``).
"""
