"""The covariance ellipsoid comparison (counterpart of
``examples/covariance-ellipsoids``): ``main.world`` and ``main.system``."""
