"""s10-style process orchestration recipes (libs/s10/src/recipe.rs).

The reference's s10 launches sidecar processes (SITL controllers, render
servers) next to a sim and supervises them with restart policies, readiness
probes, and a liveness heartbeat.  This Python implementation keeps the
recipe model and subprocess supervision; the engine itself never needs
process-per-sample (Monte Carlo batches on-device), so recipes only serve
external co-processes.

Process-tree cleanup: children spawn in their own session
(start_new_session) and stop() kills the whole process group — the
portable equivalent of the reference's cgroup teardown (cgroup.rs; cgroup
v2 kill-files are not available in every deployment, including this one).

A host-only copy of ``elodin_tpu/s10.py``: the port imports nothing of the
JAX package.  One change: the port's sims are package modules with
relative imports, which ``python <path>`` cannot run, so ``SimRecipe``
runs ``python -m elodin_tpu_torch run <path> <addr>``, where ``path`` is a
sim file or a dotted module; the sim runs on the card unless the recipe's
``device`` says otherwise (passed as ``--device``).
"""

from __future__ import annotations

import os
import shlex
import signal
import subprocess
import time
from dataclasses import dataclass, field


def _expand_env(s: str, lookup=None) -> str:
    """``${VAR}`` / ``${VAR:-default}`` expansion (probe.rs expand_env)."""
    import re

    lookup = lookup or os.environ.get

    def sub(m):
        name, default = m.group(1), m.group(2)
        val = lookup(name)
        return val if val is not None else (default or "")

    return re.sub(r"\$\{([A-Za-z0-9_]+)(?::-([^}]*))?\}", sub, s)


@dataclass
class ReadyProbe:
    """Readiness probe (libs/s10/src/probe.rs ReadyProbe): tcp | unix |
    file | log | delay."""

    type: str = "delay"
    addr: str = ""
    path: str = ""
    pattern: str = ""
    ms: int = 0

    @staticmethod
    def from_dict(spec: dict) -> "ReadyProbe":
        return ReadyProbe(
            type=spec.get("type", "delay"),
            addr=spec.get("addr", ""),
            path=str(spec.get("path", "")),
            pattern=spec.get("pattern", ""),
            ms=int(spec.get("ms", 0)),
        )

    def check(self, log_path: str | None = None) -> bool:
        if self.type == "tcp":
            import socket

            host, _, port = _expand_env(self.addr).rpartition(":")
            # '[::1]:2240' / '[::]:2240' — strip brackets, map any-addr to
            # loopback for the connect probe; bad/missing ports report
            # not-ready instead of crashing the supervisor loop
            host = host.strip("[]")
            if host in ("::", "0.0.0.0", ""):
                host = "127.0.0.1"
            try:
                with socket.create_connection(
                    (host, int(port)), timeout=0.25
                ):
                    return True
            except (OSError, ValueError):
                return False
        if self.type == "unix":
            import socket

            s = socket.socket(socket.AF_UNIX)
            try:
                s.connect(_expand_env(self.path))
                return True
            except OSError:
                return False
            finally:
                s.close()
        if self.type == "file":
            return os.path.exists(_expand_env(self.path))
        if self.type == "log":
            if not log_path or not os.path.exists(log_path):
                return False
            import re

            pat = re.compile(_expand_env(self.pattern))
            with open(log_path, "r", errors="replace") as f:
                return any(pat.search(line) for line in f)
        return True  # delay handled by wait()

    def wait(self, timeout: float, log_path: str | None = None) -> bool:
        if self.type == "delay":
            time.sleep(self.ms / 1e3)
            return True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.check(log_path):
                return True
            time.sleep(0.1)
        return False


class LivenessMonitor:
    """UDP beacon listener (libs/s10/src/liveness.rs serve/monitor): sims
    send {"age_s": ...} heartbeats; the supervisor kills children whose
    last beacon is older than the timeout."""

    def __init__(self):
        import socket
        import threading

        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]
        self.last_beat: float = time.monotonic()
        self._stop = False
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _pump(self) -> None:
        self.sock.settimeout(0.25)
        while not self._stop:
            try:
                self.sock.recvfrom(1024)
                self.last_beat = time.monotonic()
            except OSError:
                continue

    def age(self) -> float:
        return time.monotonic() - self.last_beat

    def stop(self) -> None:
        self._stop = True
        try:
            self.sock.close()
        except OSError:
            pass


@dataclass
class ProcessRecipe:
    name: str
    cmd: str
    args: list[str] = field(default_factory=list)
    cwd: str | None = None
    env: dict[str, str] = field(default_factory=dict)
    restart_policy: str = "never"  # never | on-failure | always
    ready_timeout: float | None = None
    ready: ReadyProbe | None = None
    liveness_timeout: float | None = None  # kill if beacon older than this
    watch: list[str] = field(default_factory=list)  # paths to watch

    def spawn(self) -> "RunningProcess":
        env = dict(os.environ)
        env.update(self.env)
        monitor = None
        args = list(self.args)
        if self.liveness_timeout:
            monitor = LivenessMonitor()
            args += ["--liveness-port", str(monitor.port)]
        log_path = None
        stdout = None
        if self.ready is not None and self.ready.type == "log":
            import tempfile

            fd, log_path = tempfile.mkstemp(prefix=f"s10-{self.name}-",
                                            suffix=".log")
            stdout = os.fdopen(fd, "wb")
        proc = subprocess.Popen(
            [self.cmd, *args],
            cwd=self.cwd,
            env=env,
            start_new_session=True,
            stdout=stdout,
            stderr=subprocess.STDOUT if stdout else None,
        )
        rp = RunningProcess(self, proc)
        rp.monitor = monitor
        rp.log_path = log_path
        rp.watch_state = _watch_snapshot(self.watch, self.cwd)
        return rp


@dataclass
class SimRecipe:
    name: str
    path: str
    addr: str = "[::]:2240"
    optimize: bool = False
    env: dict[str, str] = field(default_factory=dict)
    liveness_timeout: float | None = None
    watch: list[str] = field(default_factory=list)
    restart_policy: str = "never"
    device: str | None = None  # the sim's --device; None: the card

    def spawn(self) -> "RunningProcess":
        import sys

        args = ["-m", "elodin_tpu_torch", "run", self.path, self.addr]
        if self.device is not None:
            args += ["--device", self.device]
        # the child imports this package from the checkout that holds it
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(self.env)
        path = env.get("PYTHONPATH", os.environ.get("PYTHONPATH", ""))
        env["PYTHONPATH"] = os.pathsep.join(p for p in (root, path) if p)
        recipe = ProcessRecipe(
            name=self.name,
            cmd=sys.executable,
            args=args,
            env=env,
            restart_policy=self.restart_policy,
            liveness_timeout=self.liveness_timeout,
            watch=list(self.watch),
        )
        return recipe.spawn()


@dataclass
class GroupRecipe:
    name: str
    recipes: list = field(default_factory=list)


def _watch_snapshot(paths: list[str], cwd: str | None) -> dict[str, float]:
    """mtime snapshot of watched files (watch mode, s10 README)."""
    import glob

    out: dict[str, float] = {}
    for pattern in paths or []:
        if cwd and not os.path.isabs(pattern):
            pattern = os.path.join(cwd, pattern)
        for p in glob.glob(pattern, recursive=True):
            try:
                out[p] = os.stat(p).st_mtime
            except OSError:
                pass
    return out


class RunningProcess:
    def __init__(self, recipe: ProcessRecipe, proc: subprocess.Popen):
        self.recipe = recipe
        self.proc = proc
        self.monitor: LivenessMonitor | None = None
        self.log_path: str | None = None
        self.watch_state: dict[str, float] = {}

    def poll(self):
        return self.proc.poll()

    def wait_ready(self, timeout: float | None = None) -> bool:
        probe = getattr(self.recipe, "ready", None)
        if probe is None:
            return True
        return probe.wait(
            timeout or self.recipe.ready_timeout or 30.0, self.log_path
        )

    def liveness_stale(self) -> bool:
        lt = getattr(self.recipe, "liveness_timeout", None)
        return (
            lt is not None
            and self.monitor is not None
            and self.monitor.age() > lt
        )

    def sources_changed(self) -> bool:
        w = getattr(self.recipe, "watch", None)
        if not w:
            return False
        return _watch_snapshot(w, self.recipe.cwd) != self.watch_state

    def stop(self, timeout: float = 5.0) -> None:
        if self.monitor is not None:
            self.monitor.stop()
        if self.proc.poll() is not None:
            return
        try:
            os.killpg(os.getpgid(self.proc.pid), signal.SIGTERM)
        except ProcessLookupError:
            return
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                return
            time.sleep(0.05)
        try:
            os.killpg(os.getpgid(self.proc.pid), signal.SIGKILL)
        except ProcessLookupError:
            pass


class PyRecipe:
    """Factory matching the reference's `el.s10.PyRecipe` bindings
    (libs/nox-py/src/s10.rs)."""

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name

    @staticmethod
    def process(name: str, cmd: str, args: list[str] | None = None,
                cwd: str | None = None, env: dict | None = None) -> "PyRecipe":
        if args is None and " " in cmd:
            parts = shlex.split(cmd)
            cmd, args = parts[0], parts[1:]
        return PyRecipe(
            ProcessRecipe(
                name=name, cmd=cmd, args=list(args or []), cwd=cwd,
                env=dict(env or {}),
            )
        )

    @staticmethod
    def sim(name: str, path: str, addr: str = "[::]:2240",
            device: str | None = None) -> "PyRecipe":
        return PyRecipe(SimRecipe(name=name, path=path, addr=addr,
                                  device=device))

    def to_json(self) -> str:
        import dataclasses
        import json

        return json.dumps(dataclasses.asdict(self.inner))

    def spawn(self) -> RunningProcess:
        return self.inner.spawn()


class Supervisor:
    """Recipe supervisor with restart policies, liveness enforcement,
    watch mode, and an admission budget (libs/s10/src/lib.rs run loop +
    admission.rs S10_MAX_INFLIGHT: at most N recipes run concurrently,
    the rest queue until a slot frees)."""

    def __init__(self, max_inflight: int | None = None):
        self.running: list[RunningProcess] = []
        self.queued: list = []
        if max_inflight is None:
            env = os.environ.get("S10_MAX_INFLIGHT")
            max_inflight = int(env) if env else None
        self.max_inflight = max_inflight

    def _slots_free(self) -> int:
        if self.max_inflight is None:
            return 1 << 30
        live = sum(1 for rp in self.running if rp.poll() is None)
        return max(0, self.max_inflight - live)

    def start(self, recipes) -> None:
        for r in recipes:
            obj = r.inner if isinstance(r, PyRecipe) else r
            if hasattr(obj, "spawn"):
                if self._slots_free() > 0:
                    self.running.append(obj.spawn())
                else:
                    self.queued.append(obj)

    def tick(self) -> None:
        for i, rp in enumerate(self.running):
            code = rp.poll()
            if code is None:
                # liveness enforcement: a hung sim (stale beacon) is killed
                # and treated as a failure (liveness.rs monitor, wired at
                # world_builder.rs:646-648)
                if rp.liveness_stale():
                    rp.stop()
                    code = -9
                elif rp.sources_changed():
                    # watch mode: restart on source change regardless of
                    # restart policy
                    rp.stop()
                    self.running[i] = rp.recipe.spawn()
                    continue
                else:
                    continue
            policy = getattr(rp.recipe, "restart_policy", "never")
            if policy == "always" or (policy == "on-failure" and code != 0):
                self.running[i] = rp.recipe.spawn()
        # admit queued recipes into freed slots
        while self.queued and self._slots_free() > 0:
            self.running.append(self.queued.pop(0).spawn())

    def wait_ready(self, timeout: float = 30.0) -> bool:
        return all(rp.wait_ready(timeout) for rp in self.running)

    def stop_all(self) -> None:
        for rp in self.running:
            rp.stop()
        self.running.clear()


# -- TOML recipes + CLI (parity: s10 binary loading s10.toml,
# libs/s10/src/recipe.rs serde with tag = "type") ---------------------------


def load_toml(path: str) -> dict:
    """Parse an s10.toml into {name: recipe} (Recipe enum tagged by
    `type` = process | sim | group)."""
    import tomllib

    with open(path, "rb") as f:
        data = tomllib.load(f)
    recipes = {}
    for name, spec in data.get("recipes", data).items():
        if not isinstance(spec, dict):
            continue
        recipes[name] = _recipe_from_dict(name, spec)
    return recipes


def _recipe_from_dict(name: str, spec: dict):
    ty = spec.get("type", "process")
    if ty == "process":
        return ProcessRecipe(
            name=name,
            cmd=spec["cmd"],
            args=[str(a) for a in spec.get("args", [])],
            cwd=spec.get("cwd"),
            env={k: str(v) for k, v in spec.get("env", {}).items()},
            restart_policy=spec.get("restart_policy", "never"),
            ready=(
                ReadyProbe.from_dict(spec["ready"])
                if isinstance(spec.get("ready"), dict)
                else None
            ),
            ready_timeout=spec.get("ready_timeout"),
            liveness_timeout=spec.get("liveness_timeout"),
            watch=[str(w) for w in spec.get("watch", [])],
        )
    if ty == "sim":
        return SimRecipe(
            name=name,
            path=spec["path"],
            addr=spec.get("addr", "[::]:2240"),
            env={k: str(v) for k, v in spec.get("env", {}).items()},
            liveness_timeout=spec.get("liveness_timeout"),
            watch=[str(w) for w in spec.get("watch", [])],
            restart_policy=spec.get("restart_policy", "never"),
            device=spec.get("device"),
        )
    if ty == "group":
        return GroupRecipe(
            name=name,
            recipes=[
                _recipe_from_dict(n, s)
                for n, s in spec.get("recipes", {}).items()
            ],
        )
    raise ValueError(f"unknown recipe type {ty!r} for {name!r}")


def run_recipes(recipes) -> Supervisor:
    """Start recipes under a Supervisor.  Watch mode is a per-recipe
    property (``Recipe.watch`` path list, checked in ``Supervisor.tick``);
    callers drive the tick cadence themselves."""
    sup = Supervisor()
    flat = []
    for r in recipes.values() if isinstance(recipes, dict) else recipes:
        if isinstance(r, GroupRecipe):
            flat.extend(r.recipes)
        else:
            flat.append(r)
    sup.start(flat)
    return sup


def main(argv=None) -> None:
    import argparse
    import time as _time

    p = argparse.ArgumentParser(prog="s10")
    sub = p.add_subparsers(dest="cmd", required=True)
    run_p = sub.add_parser("run")
    run_p.add_argument("config", nargs="?", default="s10.toml")
    run_p.add_argument("--once", action="store_true",
                       help="exit when every recipe has exited")
    args = p.parse_args(argv)

    recipes = load_toml(args.config)
    sup = run_recipes(recipes)
    try:
        while True:
            sup.tick()
            if args.once and all(rp.poll() is not None for rp in sup.running):
                break
            _time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        sup.stop_all()


if __name__ == "__main__":
    main()
