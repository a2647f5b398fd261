"""The crazyflie-edu lab as a sim CLI (counterpart of
``examples/crazyflie-edu/main.py``):

    python -m elodin_tpu_torch.examples.crazyflie_edu.main bench --ticks 500 --device cpu
"""

from .sim import SIM_TIME_STEP, system, world

if __name__ == "__main__":
    world().run(system(), simulation_rate=1.0 / SIM_TIME_STEP)
