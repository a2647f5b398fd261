"""The plain references against themselves and against physics, at tiny
sizes on the CPU."""

import json

import numpy as np
import pytest
import torch

from benchmark.harness import gaps, spec
from benchmark.harness.plain import run_ticks


def _config(name):
    return json.loads((spec.BENCH_DIR / "configs" / f"{name}.json").read_text())


def _ref(name):
    return spec.load_module(spec.BENCH_DIR / "configs" / f"{name}.py")


def _columns(name, n, seed):
    cols = _ref(name).initial_columns(n, np.random.default_rng(seed), _config(name))
    return tuple(torch.from_numpy(c) for c in cols)


@pytest.mark.parametrize("name, ticks", [("leo6dof", 30), ("nbody", 5)])
def test_bodies_are_independent_of_their_batch(name, ticks):
    """A rollout of two stacked sets equals each set's own, bitwise (the
    leo6dof bodies are independent; an n-body set is its own system, so
    the stack is compared with the n-body sets one by one only for
    leo6dof, and with itself run twice for nbody)."""
    ref, conf = _ref(name), _config(name)
    a, b = _columns(name, 16, 1), _columns(name, 16, 2)
    one = ref.rollout(*a, ticks, conf)
    if name == "leo6dof":
        both = ref.rollout(*(torch.cat([x, y]) for x, y in zip(a, b)), ticks, conf)
        assert torch.equal(both[0][:16], one[0]) and torch.equal(both[1][:16], one[1])
    else:
        again = ref.rollout(*a, ticks, conf)
        assert torch.equal(again[0], one[0]) and torch.equal(again[1], one[1])


def test_leo_reference_keeps_a_free_orbit_energy():
    """No thrust, torque or drag: RK4 keeps a circular orbit's specific
    energy to 1e-12 over 600 ticks, and the attitude a unit quaternion."""
    conf = dict(_config("leo6dof"), thrust_n_per_kg=0.0, torque_nm_per_kg=0.0,
                drag_n_s2_m2=0.0)
    pos, vel, inertia = _columns("leo6dof", 8, 3)
    p, v = _ref("leo6dof").rollout(pos, vel, inertia, 600, conf)

    def energy(p, v):
        return 0.5 * (v[:, 3:] ** 2).sum(-1) - conf["mu_m3_s2"] / p[:, 4:].norm(dim=-1)

    e0, e1 = energy(pos, vel), energy(p, v)
    assert ((e1 - e0).abs() / e0.abs()).max() < 1e-12
    assert ((p[:, :4].norm(dim=-1) - 1).abs()).max() < 1e-14


def test_nbody_reference_keeps_momentum_and_pairs_opposite():
    conf = _config("nbody")
    pos, vel, inertia = _columns("nbody", 64, 4)
    m = inertia[:, 6]
    p, v = _ref("nbody").rollout(pos, vel, inertia, 10, conf)
    before, after = (m[:, None] * vel[:, 3:]).sum(0), (m[:, None] * v[:, 3:]).sum(0)
    scale = (m[:, None] * vel[:, 3:]).abs().sum(0).max()
    assert ((after - before).abs() / scale).max() < 1e-14
    x = torch.tensor([[0.0, 0.0, 0.0], [3.0, 4.0, 0.0]], dtype=torch.float64)
    a = _ref("nbody").gravity(x, torch.tensor([2.0, 1.0], dtype=torch.float64), 1.0, 0.0)
    assert torch.allclose(a[0], torch.tensor([3.0, 4.0, 0.0], dtype=torch.float64) / 125)
    assert torch.allclose(a[1], -2 * a[0])


@pytest.mark.parametrize("name, ticks, lower", [("leo6dof", 200, 1e-6), ("nbody", 10, 1e-6)])
def test_the_reference_one_precision_lower_fails_the_gap(name, ticks, lower):
    """The control at a size a test run holds: the reference in float32
    reads a gap far above what float64 against itself reads (0)."""
    ref, conf = _ref(name), _config(name)
    cols = _columns(name, 32, 5)
    state = ("world_pos", "world_vel")
    start = dict(zip(state, cols[:2]))
    f64 = dict(zip(state, ref.rollout(*cols, ticks, conf)))
    f32 = dict(zip(state, ref.rollout(*cols, ticks, conf, dtype=torch.float32)))
    assert gaps.worst(gaps.change_gaps(start, f64, f64).values()) == 0.0
    assert gaps.worst(gaps.change_gaps(start, f32, f64).values()) > lower


def test_captured_blocks_match_single_ticks_on_the_cpu():
    """Off a card ``run_ticks`` steps one tick at a time whatever the block."""
    state = (torch.arange(4.0),)
    assert torch.equal(run_ticks(lambda s: (s[0] * 2,), state, 3, graph_ticks=2)[0],
                       torch.arange(4.0) * 8)
