"""The bouncing ball with wind and drag (counterpart of ``examples/ball``):
``sim.world`` / ``sim.system``, or ``sim.build_world`` /
``sim.build_system``."""
