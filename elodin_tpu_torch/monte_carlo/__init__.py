"""Monte Carlo campaign support (counterpart of
``elodin_tpu/monte_carlo/__init__.py``).

``Param`` / ``params_spec`` / ``params`` / ``result`` / ``port`` and LHS plan
sampling are host-only copies of the JAX package's; ``batched`` runs a
whole campaign on one torch device, the sample axis under
``torch.func.vmap``.  Not ported yet: the process-per-sample ``campaign``
runner and ``calibrate``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from .sample import lhs_units, sample_dist, sample_plan, materialize_plan  # noqa: F401

CONTEXT_ENV = "ELODIN_MONTE_CARLO_CONTEXT"

_PARAM_SPEC: dict | None = None


class Param:
    """One tunable campaign parameter
    (libs/nox-py/src/monte_carlo.rs:45-84)."""

    def __init__(self, type_, default=None, min=None, max=None):
        if isinstance(type_, type):
            self.type_name = type_.__name__
        else:
            self.type_name = str(type_)
        self.default = default
        self.min = min
        self.max = max

    def to_dict(self):
        return {
            "type": self.type_name,
            "default": self.default,
            "min": self.min,
            "max": self.max,
        }


class ParamsSpec:
    def __init__(self, params: dict[str, Param]):
        self.params = params

    def to_json(self) -> str:
        return json.dumps(
            {"params": {k: v.to_dict() for k, v in self.params.items()}},
            indent=2,
        )


class Params:
    """Resolved per-run parameters (libs/nox-py/src/monte_carlo.rs:100-189)."""

    def __init__(self, values: dict, run_id=None, seed=None, db_path=None,
                 db_addr=None, cache_dir=None, run_dir=None, meta=None,
                 slots=None):
        self._values = dict(values)
        self.run_id = run_id
        self.seed = seed
        self.db_path = db_path
        self.db_addr = db_addr
        self.cache_dir = cache_dir
        self.run_dir = run_dir
        self._meta = dict(meta or {})
        self._slots = dict(slots or {})

    def get(self, key, default=None):
        return self._values.get(key, default)

    def __getitem__(self, key):
        return self._values[key]

    def as_overrides_dict(self):
        return dict(self._values)

    @property
    def meta(self):
        return dict(self._meta)

    def slots(self):
        return dict(self._slots)

    def ports(self):
        ports = self._slots.get("ports", {})
        return {k: int(v) for k, v in ports.items()}


def params_spec(**kwargs) -> ParamsSpec:
    global _PARAM_SPEC
    for k, v in kwargs.items():
        if not isinstance(v, Param):
            raise TypeError(
                f"params_spec value for `{k}` must be el.monte_carlo.Param"
            )
    spec = ParamsSpec(dict(kwargs))
    _PARAM_SPEC = spec
    return spec


_CTX_CACHE: dict[str, dict] = {}


def _load_context(path: str) -> dict:
    """The campaign context file is immutable for the process lifetime —
    parse it once instead of re-reading it on every params()/port()/
    result() call across thousands of campaign processes."""
    ctx = _CTX_CACHE.get(path)
    if ctx is None:
        ctx = json.loads(Path(path).read_text())
        _CTX_CACHE[path] = ctx
    return ctx


def params(spec: ParamsSpec | None = None) -> Params:
    spec = spec or _PARAM_SPEC
    values = {}
    if spec is not None:
        values.update({k: p.default for k, p in spec.params.items()})
    ctx_path = os.environ.get(CONTEXT_ENV)
    if ctx_path:
        ctx = _load_context(ctx_path)
        values.update(ctx.get("params", {}))
        return Params(
            values,
            run_id=ctx.get("run_id"),
            seed=ctx.get("seed"),
            db_path=ctx.get("db_path"),
            db_addr=ctx.get("db_addr"),
            cache_dir=ctx.get("cache_dir"),
            run_dir=ctx.get("run_dir"),
            meta=ctx.get("meta", {}),
            slots=ctx.get("slots", {}),
        )
    return Params(values)


def spec_json() -> str:
    if _PARAM_SPEC is None:
        return json.dumps({"params": {}}, indent=2)
    return _PARAM_SPEC.to_json()


def port(name: str, default: int | None = None) -> int:
    env = f"ELODIN_MC_PORT_{name.upper()}"
    if env in os.environ:
        return int(os.environ[env])
    p = params(None)
    ports = p.ports()
    if name in ports:
        return ports[name]
    if default is None:
        raise KeyError(name)
    return default


def result(**kwargs) -> None:
    """Write the per-run score (libs/nox-py/src/monte_carlo.rs:283-305)."""
    if not kwargs:
        return
    run_dir = params(None).run_dir
    if run_dir is None:
        # standalone run: print instead of failing so sims stay runnable
        print("monte_carlo.result:", json.dumps(kwargs))
        return
    path = Path(run_dir) / "result.json"
    path.write_text(json.dumps(kwargs, indent=2))


from .batched import BatchedCampaign, BatchedResult, run_batched, write_artifacts  # noqa: E402,F401

__all__ = [
    "Param",
    "Params",
    "ParamsSpec",
    "params_spec",
    "params",
    "result",
    "port",
    "spec_json",
    "lhs_units",
    "sample_dist",
    "sample_plan",
    "materialize_plan",
    "BatchedCampaign",
    "BatchedResult",
    "run_batched",
    "write_artifacts",
]
