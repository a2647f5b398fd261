"""The frame-correctness regression sim (counterpart of
``examples/frames``): ``main.run_drop``, ``main.build_two_body`` and
``main.total_energy``."""
