"""Running a plain reference's tick many times.

A reference tick is a few hundred small PyTorch ops, so a rollout of
thousands of ticks is bound by issuing them from Python.  On a card, blocks
of ticks are captured once into a CUDA graph and replayed: the same ops in
the same order on the same values, issued without the interpreter.
"""

from __future__ import annotations

import torch


def run_ticks(step, state: tuple, ticks: int, graph_ticks: int = 0) -> tuple:
    """``step`` applied ``ticks`` times to the tuple of tensors ``state``.
    On a CUDA device with ``graph_ticks > 0`` the ticks run in captured
    blocks of ``graph_ticks``; elsewhere, and for the ticks left over, one
    at a time."""
    if state[0].device.type != "cuda" or graph_ticks <= 0 or ticks < graph_ticks:
        for _ in range(ticks):
            state = step(state)
        return state

    def block(s):
        for _ in range(graph_ticks):
            s = step(s)
        return s

    held = tuple(x.clone() for x in state)
    side = torch.cuda.Stream()  # capture warms up on a side stream first
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        block(held)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = block(held)
    blocks, rest = divmod(ticks, graph_ticks)
    for _ in range(blocks):
        graph.replay()
        for a, b in zip(held, out):
            a.copy_(b)
    state = tuple(x.clone() for x in held)
    del graph, out, held
    for _ in range(rest):
        state = step(state)
    return state
