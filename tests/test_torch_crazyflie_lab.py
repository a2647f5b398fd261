"""crazyflie-edu's scripted lab, whole (8500 ticks at 500 Hz, on the CPU in
f64), with every gate of its JAX test (tests/test_examples.py:571-590).
Its first 4000 ticks are held against the JAX package's run in
``tests/test_torch_flight_examples.py``.
"""

import numpy as np

from elodin_tpu_torch.examples.crazyflie_edu import sim as cf
from torch_port_util import float_policy


def test_crazyflie_edu_whole_lab():
    with float_policy("f64"):
        ex = cf.world().build(cf.system(), simulation_rate=cf.SIM_RATE_HZ, device="cpu")
        ex.record_history = False

        def pos():
            return np.asarray(ex.read_component("crazyflie.world_pos")).ravel()[4:]

        ex.run(1000)  # t=2s: hovering at the first waypoint
        p = pos()
        assert abs(p[2] - 0.6) < 0.05, p
        ex.run(3000)  # t=8s: corner (0.6, 0.6)
        p = pos()
        assert abs(p[0] - 0.6) < 0.05 and abs(p[1] - 0.6) < 0.05, p
        ex.run(4500)  # t=17s: landed near origin
        p = pos()
        assert p[2] < 0.08 and np.linalg.norm(p[:2]) < 0.1, p
    assert ex.tick() == 8500
