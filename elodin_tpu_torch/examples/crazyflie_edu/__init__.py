"""The Crazyflie 2.1 plant and its firmware-style control cascade
(counterpart of ``examples/crazyflie-edu``): ``config`` (the airframe),
``sim`` (the systems and the world) and ``main`` (the sim CLI)."""
