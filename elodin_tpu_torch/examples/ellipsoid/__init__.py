"""The sensor-camera frustum and ellipsoid demo (counterpart of
``examples/ellipsoid``): ``sim.world`` and ``sim.system``."""
