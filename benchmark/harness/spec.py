"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: ``configs/<name>.json`` (its sizes, as its entry in
  ``BENCHMARK.json`` names the file) and ``configs/<name>.py`` (its plain
  reference and its initial draws);
* a cell: ``workloads/<name>.json`` (its traffic and its limits);
* an entry driver: ``entries/<entry>.py``, the entry a cell names;
* a per-layer metric: ``metrics/<name>.py``, a ``read(trace)`` function.

A later change adds a configuration, a cell or a metric as new files and a
new entry in ``BENCHMARK.json``, and edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_module(path: Path):
    """The Python file at ``path`` as a module of its own (names may hold
    dots and dashes, so they are not imported as packages)."""
    name = "benchmark_file_" + "_".join(path.relative_to(BENCH_DIR).with_suffix("").parts)
    spec = importlib.util.spec_from_file_location(name.replace(".", "_").replace("-", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    chips: int
    traffic: dict  # workloads/<name>.json
    config_name: str
    config: dict  # the configuration's file
    end_to_end: list  # the metrics of BENCHMARK.json this cell reports
    per_layer: list

    def entry(self):
        return load_module(BENCH_DIR / "entries" / f"{self.traffic['entry']}.py")

    def reference(self):
        return load_module(BENCH_DIR / "configs" / f"{self.config_name}.py")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (KeyError if it has none)."""
    bench = load_benchmark(root) if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    traffic = json.loads((BENCH_DIR / "workloads" / f"{name}.json").read_text())
    if traffic.get("config") != w["config"]:
        raise ValueError(f"workloads/{name}.json names config {traffic.get('config')!r}, "
                         f"BENCHMARK.json {w['config']!r}")
    return Cell(
        name=name, chips=int(w["chips"]), traffic=traffic, config_name=w["config"],
        config=json.loads((root / conf["file"]).read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    return load_module(BENCH_DIR / "metrics" / f"{name}.py").read
