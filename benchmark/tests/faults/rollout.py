"""Faults planted under the ``rollout`` entry, in ``sixdof_rollout``."""


def broken(kind):
    """(owner, attribute, replacement): ``sixdof_rollout`` returning the
    state unchanged (``unchanged``), with half of the bodies left out
    (``half``), or with one answer altered (``altered``)."""
    from elodin_tpu_torch.ops import sixdof_kernel

    real = sixdof_kernel.sixdof_rollout

    def broken(pos, vel, inertia, dt, ticks, **kw):
        if kind == "unchanged":  # the state returned as it came
            return pos.clone(), vel.clone()
        p, v = real(pos, vel, inertia, dt, ticks, **kw)
        if kind == "half":  # half of the bodies left out
            n = pos.shape[0] // 2
            p[n:], v[n:] = pos[n:], vel[n:]
        else:  # one answer altered where it is produced
            p[0, 4] *= 1 + 1e-6
        return p, v

    return sixdof_kernel, "sixdof_rollout", broken
