"""``ecs_device_ms_per_tick``: device ms a tick in the calls' ops other
than K1 and K2: the ECS tick's own ops (``build_step``, ``six_dof``, the
queries and the edge fold)."""

KERNELS = ("sixdof_rk4", "pairwise_gravity")


def read(trace):
    if not trace.ticks or not trace.call_ops:
        return None
    ns = sum(op.dur_ns for op in trace.call_ops if not any(k in op.name for k in KERNELS))
    return ns / 1e6 / trace.ticks
