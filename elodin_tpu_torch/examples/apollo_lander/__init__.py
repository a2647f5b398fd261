"""The Apollo-style lunar powered descent (counterpart of
``examples/apollo-lander``): ``main.build_world``, ``main.build_system``,
``main.run_dispersed``."""
