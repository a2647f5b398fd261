"""rc-jet's mission, whole (11520 ticks at 240 Hz, on the CPU in f64),
with every gate of its JAX test (tests/test_examples.py:623-647).  Its
first 2400 ticks are held against the JAX package's run in
``tests/test_torch_flight_examples.py``.
"""

import numpy as np

from elodin_tpu_torch.examples.rc_jet import sim as rj
from torch_port_util import float_policy


def test_rc_jet_whole_mission():
    with float_policy("f64"):
        ex = rj.world().build(rj.system(), simulation_rate=rj.SIM_RATE_HZ, device="cpu")
        ex.record_history = False

        def state():
            pos = np.asarray(ex.read_component("bdx.world_pos")).ravel()
            vel = np.asarray(ex.read_component("bdx.world_vel")).ravel()
            ab = np.degrees(np.asarray(ex.read_component("bdx.alpha_beta")).ravel())
            hdg = np.degrees(np.arctan2(vel[4], vel[3]))
            return pos[6], np.linalg.norm(vel[3:]), hdg, ab

        ex.run(int(10 * rj.SIM_RATE_HZ))  # t=10s: cruise
        alt, spd, hdg, _ = state()
        assert abs(alt - 120.0) < 10.0 and abs(hdg - 90.0) < 2.0, (alt, hdg)
        ex.run(int(18 * rj.SIM_RATE_HZ))  # t=28s: climbed
        alt, spd, hdg, _ = state()
        assert abs(alt - 160.0) < 8.0, alt
        ex.run(int(20 * rj.SIM_RATE_HZ))  # t=48s: turned
        alt, spd, hdg, ab = state()
        assert abs(hdg - 180.0) < 5.0, hdg
        assert abs(alt - 160.0) < 10.0, alt
        assert 30.0 < spd < 42.0, spd
        assert abs(ab[1]) < 2.0, ab  # coordinated: low sideslip
    assert ex.tick() == 11520
