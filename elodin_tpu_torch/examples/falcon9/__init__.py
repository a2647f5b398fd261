"""The falcon9 RTLS booster mission (counterpart of ``examples/falcon9``),
with its user systems written in torch ops: ``sim.build`` makes the world
and the tick's system (``main.build_world`` adds the editor's layout, and
``main`` is the sim CLI), ``batched.run_campaign`` runs a dispersed
campaign through ``monte_carlo.BatchedCampaign`` (without the sensors,
which no system reads), and ``sensors`` holds the sensor suite's
components and its noise."""
