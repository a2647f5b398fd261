"""Falcon 9 RTLS mission: the sim CLI's entry (counterpart of
``examples/falcon9/main.py``; the mission model is ``sim.py``), with the
editor's layout.

    python -m elodin_tpu_torch.examples.falcon9.main bench --ticks 50 --device cpu
"""

from .sim import SIM_RATE_HZ, build


def build_world():
    """``sim.build()``'s world and system, with the JAX example's schematic."""
    w, sys_ = build()
    w.schematic(
        """
        coordinate frame=ENU lat=28.60839 lon=-80.60433 alt=3.0
        hsplit {
            viewport name=Viewport look_at="booster.world_pos" show_grid=#true
            vsplit {
                graph name="Altitude" eql="booster.world_pos"
                graph name="Phase" eql="booster.phase"
                graph name="Propellant" eql="booster.prop_kg"
            }
        }
        """
    )
    return w, sys_


if __name__ == "__main__":
    w, sys_ = build_world()
    w.run(sys_, simulation_rate=SIM_RATE_HZ)
