"""The rotating cube (counterpart of ``examples/rotating-cube``):
``sim.world`` and ``sim.system``."""
