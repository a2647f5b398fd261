"""The EDU-450 quad-X drone (counterpart of ``examples/drone``): a 300 Hz
flight controller flying on an MEKF attitude estimate over a 900 Hz
plant and IMU.  ``main.build_world`` / ``main.build_system``.  The JAX
example loads its modules through a ``sys.modules`` loader; here they are
the package's modules, with relative imports."""
