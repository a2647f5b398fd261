"""Process-mode entry of the landing campaign (counterpart of
``examples/monte-carlo/main.py``): reads the dispersed parameters from the
campaign context, runs headless, and reports a score through
``el.monte_carlo.result``.

``monte_carlo.run_campaign`` starts it as ``python main.py run [--device
DEV]``, a file rather than a module, so its imports are absolute.
"""

import numpy as np

import elodin_tpu_torch as el
from elodin_tpu_torch.examples.monte_carlo.sim import (
    DEFAULT_MAX_TICKS,
    PARAMS,
    SIMULATION_RATE_HZ,
    build,
)


def post_step(tick: int, ctx: el.StepContext) -> None:
    if tick >= DEFAULT_MAX_TICKS - 1:
        td = float(ctx.read_component("booster.touchdown_vz")[0])
        pos = np.asarray(ctx.read_component("booster.world_pos"))
        el.monte_carlo.result(
            touchdown_vz=td,
            landing_offset=float(np.linalg.norm(pos[4:6])),
            soft=bool(-5.0 < td < 0.0),
        )


def main() -> None:
    params = el.monte_carlo.params(el.monte_carlo.params_spec(**PARAMS))
    world, system = build(params.as_overrides_dict())
    world.run(
        system,
        simulation_rate=SIMULATION_RATE_HZ,
        max_ticks=DEFAULT_MAX_TICKS,
        post_step=post_step,
    )


if __name__ == "__main__":
    main()
