"""The cube-sat stepped through ``World.to_jax`` / ``TorchSim`` (counterpart
of ``examples/cube-sat-pysim``): ``main.run``."""
