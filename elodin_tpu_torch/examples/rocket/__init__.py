"""The finned sounding rocket (counterpart of ``examples/rocket``):
``main.build_world`` / ``main.build_system`` for one rocket through
``Exec``, ``batched.run`` for many through ``monte_carlo.BatchedCampaign``."""
