"""The op-coverage probe (counterpart of ``examples/stablehlo``):
``sim.world`` / ``sim.system``, or ``sim.build_world`` /
``sim.build_system``."""
