"""On the card, at each cell's own size: three seeds of the program come
out correct and three of the control (the reference one precision lower in
the program's place) do not.  Run there with
``python3 -m pytest benchmark/tests -m gpu``."""

import io
import json

import pytest

from benchmark import limits
from benchmark.harness import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes_at_full_size(name, card):
    out = io.StringIO()
    summary = limits.readings(name, [11, 12, 13], [21, 22, 23], 1.0, out=out)
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    assert all(r["correct"] for r in lines if not r["control"])
    assert not any(r["correct"] for r in lines if r["control"])
    for number in ("state_gap", "late_gap"):
        limit = spec.cell(name).traffic["limits"].get(number)
        if limit is not None:
            assert summary["program"][number] <= limit < summary["control"][number]
