"""The booster landing-burn Monte Carlo (counterpart of
``examples/monte-carlo``): ``sim.build`` makes the world and system of one
landing, ``batched.run_campaign`` a dispersed campaign through
``monte_carlo.BatchedCampaign``."""
