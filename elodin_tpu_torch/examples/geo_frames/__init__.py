"""The geodetic frames showcase (counterpart of ``examples/geo-frames``):
``sim.world``, ``sim.system`` and ``sim.ecef_from_enu``."""
