"""The linear-algebra op-coverage sim (counterpart of
``examples/linalg``): ``main.build_world`` / ``main.build_system``."""
