"""Gradient-based orbit retargeting through the simulator (counterpart of
``examples/orbit-retarget``): ``main.solve``."""
