"""The BDX-class RC jet with its in-graph autopilot (counterpart of
``examples/rc-jet``): ``sim`` (the systems and the world) and ``main``
(the sim CLI)."""
