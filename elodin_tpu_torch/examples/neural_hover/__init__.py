"""A neural flight controller trained through the simulator (counterpart of
``examples/neural-hover``): ``main.train`` and ``main.evaluate``."""
