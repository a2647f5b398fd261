"""The cube-sat attitude dynamics (counterpart of ``examples/cube-sat``):
EGM08 gravity, sun sensors, magnetometer, MEKF attitude estimation, LQR
pointing and reaction wheels.  ``main.build_world`` /
``main.build_system``."""
