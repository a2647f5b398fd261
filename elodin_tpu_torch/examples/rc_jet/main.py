"""The rc-jet mission as a sim CLI (counterpart of
``examples/rc-jet/main.py``):

    python -m elodin_tpu_torch.examples.rc_jet.main bench --ticks 240 --device cpu
"""

from .sim import SIM_RATE_HZ, system, world

if __name__ == "__main__":
    world().run(system(), simulation_rate=SIM_RATE_HZ)
