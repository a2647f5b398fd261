"""The sensor-camera bouncing-balls room (counterpart of
``examples/sensor-camera``): ``main.world`` and ``main.system``."""
