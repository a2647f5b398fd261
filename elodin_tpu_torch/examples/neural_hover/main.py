"""Neural flight controller trained by differentiating through the sim
(counterpart of ``examples/neural-hover/main.py``).

The policy network's weights are world components: an ``@el.map`` system
reads them beside the vehicle state and produces the thrust force, so one
``el.rollout`` closes the loop (RK4 six-dof, controller and network).
Training is ``torch.optim.Adam`` (the JAX example's ``optax.adam``: the same
rule and defaults) on the gradient of a loss batched over dispersed starts
with ``torch.func.vmap`` over whole rollouts.  The initial weights are
JAX's: ``key(seed)``, ``split``, then ``normal`` of the port's threefry, as
the JAX example draws them (within the normals' known ulps of JAX's);
``params_from_numpy`` carries any other weights across, such as the JAX
example's.

    python -m elodin_tpu_torch.examples.neural_hover.main [--iters 300] [--device cpu]

(This module defines ``@el.system`` functions, so it must not use
postponed annotations.)
"""

import argparse
import math
import sys
import typing as ty
from dataclasses import field

import numpy as np
import torch
from torch.func import vmap

import elodin_tpu_torch as el
from elodin_tpu_torch.diff import entity_row, set_entity
from elodin_tpu_torch.ops import threefry

from .._consts import const

SIM_RATE_HZ = 60.0
TICKS = 240  # 4 s horizon
MASS = 1.0
G = 9.81
TARGET = np.array([0.0, 0.0, 2.0])
MAX_THRUST = 4.0 * MASS * G  # thrust-to-weight 4
_GRAVITY = np.array([0.0, 0.0, -MASS * G])
LEARNING_RATE = 1e-2

HID = 32
N_IN = 9  # position error, velocity, tanh of the position error
N_OUT = 3
PARAMS = ("w1", "b1", "w2", "b2")

F64 = torch.float64
W1 = ty.Annotated[torch.Tensor, el.Component("w1", el.ComponentType(el.PrimitiveType.F64, (HID, N_IN)))]
B1 = ty.Annotated[torch.Tensor, el.Component("b1", el.ComponentType(el.PrimitiveType.F64, (HID,)))]
W2 = ty.Annotated[torch.Tensor, el.Component("w2", el.ComponentType(el.PrimitiveType.F64, (N_OUT, HID)))]
B2 = ty.Annotated[torch.Tensor, el.Component("b2", el.ComponentType(el.PrimitiveType.F64, (N_OUT,)))]


@el.dataclass
class Policy(el.Archetype):
    """The controller's parameters, stored as plain components."""

    w1: W1 = field(default_factory=lambda: torch.zeros((HID, N_IN), dtype=F64))
    b1: B1 = field(default_factory=lambda: torch.zeros(HID, dtype=F64))
    w2: W2 = field(default_factory=lambda: torch.zeros((N_OUT, HID), dtype=F64))
    b2: B2 = field(default_factory=lambda: torch.zeros(N_OUT, dtype=F64))


@el.map
def policy_thrust(
    pos: el.WorldPos, vel: el.WorldVel,
    w1: W1, b1: B1, w2: W2, b2: B2, f: el.Force,
) -> el.Force:
    err = const(TARGET, w1) - pos.linear()
    obs = torch.cat([err, vel.linear(), torch.tanh(err)])
    h = torch.tanh(w1 @ obs + b1)
    raw = w2 @ h + b2
    # smooth, saturating thrust map keeps gradients alive at the limits:
    # the vertical channel is one-sided [0, MAX] (a rotor cannot pull
    # down), the lateral channels symmetric (tilting redirects thrust)
    lat = 0.5 * MAX_THRUST * torch.tanh(raw[:2])
    up = MAX_THRUST * 0.5 * (torch.tanh(raw[2]) + 1.0)
    thrust = torch.cat([lat, up[None]])
    return el.Force(linear=f.force() + thrust)


@el.map
def gravity(f: el.Force) -> el.Force:
    return el.Force(linear=f.force() + const(_GRAVITY, f.inner))


def build_world(start=(1.5, -1.0, 0.5)) -> el.World:
    w = el.World()
    w.spawn(
        [
            el.Body(
                world_pos=el.WorldPos(linear=torch.as_tensor(start, dtype=F64)),
                world_vel=el.WorldVel(linear=torch.zeros(3, dtype=F64)),
                inertia=el.Inertia(MASS),
            ),
            Policy(),
        ],
        name="drone",
    )
    return w


def build_system() -> el.System:
    return el.six_dof(sys=gravity | policy_thrust)


def init_params(seed: int = 0, device="cuda") -> dict[str, torch.Tensor]:
    """The JAX example's initial weights: two normal draws from the split
    of ``key(seed)``, and the z bias near hover, tanh^-1(2 / t2w - 1)."""
    k1, k2 = threefry.split(threefry.key(seed))
    params = {
        "w1": threefry.normal(k1, (HID, N_IN), F64) * 0.3,
        "b1": torch.zeros(HID, dtype=F64),
        "w2": threefry.normal(k2, (N_OUT, HID), F64) * 0.1,
        "b2": torch.tensor([0.0, 0.0, math.atanh(2.0 / 4.0 - 1.0)], dtype=F64),
    }
    return {k: v.to(device) for k, v in params.items()}


def params_from_numpy(d: dict, device="cuda") -> dict[str, torch.Tensor]:
    """A dict of arrays (numpy, or anything ``np.asarray`` takes, such as
    the JAX example's ``params``) as the port's weights on ``device``."""
    return {k: torch.tensor(np.asarray(d[k], dtype=np.float64), device=device)
            for k in PARAMS}


def starts(batch: int, seed: int = 0) -> np.ndarray:
    """The training starts, the JAX example's draw: uniform in a box of
    +-2, +-2, +-1 m about (0, 0, 1)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.0, 1.0, size=(batch, 3)) * np.array([2.0, 2.0, 1.0])
            + np.array([0.0, 0.0, 1.0]))


def make_loss(start_points, ticks: int = TICKS, device="cuda"):
    """The training loss, a function of the weights: time-weighted tracking
    plus terminal stillness, averaged over ``start_points`` (B, 3) under
    ``torch.func.vmap``."""
    roll = el.rollout(
        build_world(), build_system(), ticks,
        outputs=("world_pos", "world_vel"), record=True,
        simulation_rate=SIM_RATE_HZ, device=device,
    )
    row = entity_row(roll.meta, "world_pos", "drone")
    pos_col0 = roll.initial_state["world_pos"]
    goal = torch.as_tensor(TARGET, dtype=F64, device=device)
    t_w = torch.linspace(0.2, 1.0, ticks, dtype=F64, device=device)[:, None]
    start_t = torch.as_tensor(np.asarray(start_points), dtype=F64, device=device)

    def loss_one(params, start):
        pos_col = set_entity(pos_col0, roll.meta, "world_pos", "drone",
                             torch.cat([pos_col0[row, :4], start]))
        traj = roll({"world_pos": pos_col, **{k: params[k] for k in PARAMS}})
        pos = traj["world_pos"][:, row, 4:]
        vel = traj["world_vel"][:, row, 3:]
        return (
            torch.mean(t_w * (pos - goal) ** 2)
            + 0.05 * torch.mean(t_w * vel**2)
            + 2.0 * torch.mean((pos[-1] - goal) ** 2)
            + 0.5 * torch.mean(vel[-1] ** 2)
        )

    def loss(params):
        return torch.mean(vmap(lambda s: loss_one(params, s))(start_t))

    return loss


def train(iters: int = 300, batch: int = 16, seed: int = 0, verbose: bool = True,
          device="cuda"):
    """Analytic-policy-gradient training from ``init_params(seed)``;
    returns (weights, final_loss)."""
    loss = make_loss(starts(batch, seed), TICKS, device)
    params = {k: v.requires_grad_() for k, v in init_params(seed, device).items()}
    opt = torch.optim.Adam(list(params.values()), lr=LEARNING_RATE)
    for i in range(iters):
        opt.zero_grad()
        val = loss(params)
        val.backward()
        opt.step()
        if verbose and (i % 25 == 0 or i == iters - 1):
            print(f"iter {i:4d}  loss = {val.item():.4f}")
    with torch.no_grad():
        final = float(loss(params))
    return {k: v.detach() for k, v in params.items()}, final


def evaluate(params, start=(1.9, 1.3, 0.2), device=None):
    """Held-out start: distance to the target and speed at the end of the
    horizon.  ``device`` defaults to the weights'."""
    device = params["w1"].device if device is None else device
    roll = el.rollout(
        build_world(start), build_system(), TICKS, outputs=("world_pos", "world_vel"),
        simulation_rate=SIM_RATE_HZ, device=device,
    )
    row = entity_row(roll.meta, "world_pos", "drone")
    with torch.no_grad():
        final = roll({k: params[k] for k in PARAMS})
    goal = torch.as_tensor(TARGET, dtype=F64, device=device)
    miss = float(torch.linalg.norm(final["world_pos"][row, 4:] - goal))
    speed = float(torch.linalg.norm(final["world_vel"][row, 3:]))
    return miss, speed


def main(argv):
    ap = argparse.ArgumentParser(description="Train a hover policy through the simulator")
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    params, _ = train(a.iters, a.batch, a.seed, device=a.device)
    miss, speed = evaluate(params)
    print(f"held-out start: final miss {miss:.3f} m at {speed:.3f} m/s")
    if a.iters >= 300 and not (miss < 0.15 and speed < 0.5):
        raise SystemExit(f"miss {miss:.3f} m or speed {speed:.3f} m/s over 0.15 / 0.5")


if __name__ == "__main__":
    main(sys.argv[1:])
