"""``entity_steps_per_s``: bodies x ticks of every call in the window, over
the window's whole wall time (host clock, from the first call's issue to
the last call's synchronize)."""


def read(window):
    return window.entity_steps / window.wall_s
