"""The three-body figure-eight orbit (counterpart of
``examples/three-body``): ``main.build_world`` and ``main.build_system``."""
