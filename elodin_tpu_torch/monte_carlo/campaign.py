"""Process-per-sample campaign runner (counterpart of
``elodin_tpu/monte_carlo/campaign.py``; the fallback path).

Kept for sims that must talk to external SITL processes over UDP lockstep —
the one case the batched on-device runner cannot absorb.  Mirrors the
reference campaign loop (libs/monte-carlo/src/lib.rs:863,1193): plan ->
worker pool -> per-run context env -> collect result.json -> results.csv +
perf.csv + resources.csv + summary.json, with:

* resume via the campaign manifest,
* an exclusive out-dir pid lock (lib.rs:1369-1373) so dueling campaigns
  fail fast instead of interleaving,
* pacing-integrity quality gates marking runs ``degraded`` (distinct from
  ``invalid``) when real-time pacing was violated (lib.rs:103-117),
* retention policies for per-run DBs (keep always/never/on-fail, compact,
  prune globs — lib.rs:194-214),
* a resource sampler recording campaign-wide RSS/CPU into resources.csv
  (lib.rs:1165-1178), and staggered worker starts.

Each sample is ``python SIM run [--device DEV]`` in its own process, started
with ``subprocess.Popen`` (never a fork of this process, which may hold a
CUDA context); the child finds this package through its ``PYTHONPATH``.
A run's telemetry database (``db/`` in its run directory) is kept, dropped
or compacted by the campaign's retention policy.
"""

from __future__ import annotations

import csv
import glob as _glob
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from .sample import materialize_plan

CONTEXT_ENV = "ELODIN_MONTE_CARLO_CONTEXT"


def _free_ports(n: int) -> list[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


class CampaignLock:
    """Exclusive flock on the out dir, held for the campaign's lifetime
    (lib.rs:1369-1373).  A second campaign pointed at the same --out fails
    fast with the holder's pid; the kernel releases the lock however the
    holder dies."""

    def __init__(self, out_dir: Path):
        import fcntl

        self.path = out_dir / ".campaign.lock"
        self.f = open(self.path, "a+")
        try:
            fcntl.flock(self.f, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            self.f.seek(0)
            holder = self.f.read().strip() or "unknown"
            self.f.close()
            raise RuntimeError(
                f"campaign out dir {out_dir} is locked by pid {holder}"
            ) from None
        self.f.truncate(0)
        self.f.write(str(os.getpid()))
        self.f.flush()

    def release(self) -> None:
        import fcntl

        try:
            fcntl.flock(self.f, fcntl.LOCK_UN)
        finally:
            self.f.close()


class ResourceSampler:
    """Periodic campaign-wide samples -> resources.csv
    (lib.rs:1165-1178): wall clock, total child RSS, child count, host
    load."""

    def __init__(self, out_dir: Path, interval: float = 0.5):
        self.rows: list[dict] = []
        self.pids: set[int] = set()
        self.out_path = out_dir / "resources.csv"
        self.interval = interval
        self._stop = threading.Event()
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def track(self, pid: int) -> None:
        self.pids.add(pid)

    @staticmethod
    def _rss_kb(pid: int) -> int:
        try:
            with open(f"/proc/{pid}/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        return int(line.split()[1])
        except OSError:
            pass
        return 0

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            live = [p for p in list(self.pids) if os.path.exists(f"/proc/{p}")]
            rss = sum(self._rss_kb(p) for p in live)
            try:
                load1 = os.getloadavg()[0]
            except OSError:
                load1 = 0.0
            self.rows.append(
                {
                    "t_s": round(time.perf_counter() - self._t0, 3),
                    "n_procs": len(live),
                    "rss_kb": rss,
                    "load1": round(load1, 2),
                }
            )

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
        if self.rows:
            with open(self.out_path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(self.rows[0]))
                w.writeheader()
                w.writerows(self.rows)


def _apply_quality(record: dict, summary: dict, quality: dict) -> None:
    """Pacing-integrity gate (lib.rs:103-117): real-time-paced sims degrade
    physics (not exit codes) under oversubscription, so violating runs are
    marked degraded — distinct from invalid."""
    record["behind_deadline_frac"] = summary.get("behind_deadline_frac")
    rtf_run = summary.get("real_time_factor_run")
    record["real_time_factor"] = rtf_run
    degraded = False
    max_frac = quality.get("max_behind_deadline_frac")
    if (
        max_frac is not None
        and record["behind_deadline_frac"] is not None
        and record["behind_deadline_frac"] > max_frac
    ):
        degraded = True
    max_ratio = quality.get("max_real_time_factor")
    if max_ratio is not None and rtf_run:
        # quality bound is on the wall/sim ratio (reference semantics)
        if (1.0 / rtf_run) > max_ratio:
            degraded = True
    record["degraded"] = degraded


def _apply_retention(run_dir: Path, record: dict, retention: dict) -> None:
    """keep/compact/prune the per-run DB and run-dir artifacts
    (lib.rs:194-214, 2294-2306)."""
    passed = record.get("valid") and not record.get("degraded")
    keep_db = retention.get("keep_run_db", "always")
    db_dir = run_dir / "db"
    if db_dir.exists():
        drop = keep_db == "never" or (keep_db == "on-fail" and passed)
        if drop:
            shutil.rmtree(db_dir, ignore_errors=True)
        elif retention.get("compact_run_db", True):
            try:
                from ..db.__main__ import _rewrite
                from ..db.storage import Database

                db = Database(str(db_dir))
                for store in db.components.values():
                    _rewrite(store)
                db.flush()
            except Exception as e:  # noqa: BLE001  (the campaign goes on)
                print(f"warning: compacting {db_dir} failed: {e}", file=sys.stderr)
    patterns = (
        retention.get("prune_on_pass", [])
        if passed
        else retention.get("prune_on_fail", [])
    )
    for pattern in patterns:
        for p in _glob.glob(str(run_dir / pattern), recursive=True):
            path = Path(p)
            if path.is_dir():
                shutil.rmtree(path, ignore_errors=True)
            else:
                path.unlink(missing_ok=True)


def _run_one(sim_path: str, row: dict, out_dir: Path, max_ticks: int | None,
             port_names: list[str], timeout: float | None,
             quality: dict, retention: dict,
             sampler: ResourceSampler | None = None,
             device: str | None = None) -> dict:
    run_id = row["run_id"]
    run_dir = out_dir / "runs" / run_id
    run_dir.mkdir(parents=True, exist_ok=True)
    ports = dict(zip(port_names, _free_ports(len(port_names))))
    ctx = {
        "run_id": run_id,
        "seed": row.get("seed"),
        "run_dir": str(run_dir),
        "db_path": str(run_dir / "db"),
        "params": {
            k.removeprefix("param."): v
            for k, v in row.items()
            if k.startswith("param.")
        },
        "meta": {},
        "slots": {"ports": ports},
    }
    ctx_path = run_dir / "context.json"
    ctx_path.write_text(json.dumps(ctx, indent=2))
    env = dict(os.environ)
    env[CONTEXT_ENV] = str(ctx_path)
    env["ELODIN_SIM_SUMMARY_JSON"] = str(run_dir / "sim_summary.json")
    # make sure the child can import the package regardless of its cwd
    import elodin_tpu_torch

    sdk_root = str(Path(elodin_tpu_torch.__file__).resolve().parent.parent)
    env["PYTHONPATH"] = os.pathsep.join(
        [sdk_root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    sim_path = str(Path(sim_path).resolve())
    args = [sys.executable, sim_path, "run"]
    if device is not None:
        args += ["--device", str(device)]
    if max_ticks is not None:
        env["ELODIN_MAX_TICKS"] = str(max_ticks)
    t0 = time.perf_counter()
    record = {"run_id": run_id, "seed": row.get("seed")}
    record.update({k: v for k, v in row.items() if k.startswith("param.")})
    try:
        proc = subprocess.Popen(
            args,
            env=env,
            cwd=str(Path(sim_path).parent),
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            # own process group: a timed-out sim is killed together with
            # any SITL/co-process children it spawned (the reference's
            # cgroup teardown equivalent, s10/src/lib.rs cgroup cleanup)
            start_new_session=True,
        )
        if sampler is not None:
            sampler.track(proc.pid)
        _out, err = proc.communicate(timeout=timeout)
        record["exit_code"] = proc.returncode
        record["valid"] = proc.returncode == 0
        if proc.returncode != 0:
            (run_dir / "stderr.log").write_text(err or "")
    except subprocess.TimeoutExpired:
        import signal

        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            proc.kill()
        proc.communicate()
        record["exit_code"] = -1
        record["valid"] = False
    record["wall_s"] = time.perf_counter() - t0

    summary_path = run_dir / "sim_summary.json"
    summary = {}
    if summary_path.exists():
        try:
            summary = json.loads(summary_path.read_text())
        except json.JSONDecodeError:
            pass
    _apply_quality(record, summary, quality)
    record["ticks"] = summary.get("ticks")

    result_path = run_dir / "result.json"
    if result_path.exists():
        for k, v in json.loads(result_path.read_text()).items():
            record[f"result.{k}"] = v
    _apply_retention(run_dir, record, retention)
    return record


def run_campaign(sim_path: str, config: dict, out_dir: str | Path,
                 workers: int = 1, max_ticks: int | None = None,
                 port_names: list[str] | None = None,
                 timeout: float | None = None,
                 resume: bool = False,
                 stagger_s: float = 0.05,
                 device: str | None = None) -> list[dict]:
    """Run every sample of ``config``'s plan as ``python SIM run`` in its
    own process, ``workers`` at a time, into ``out_dir``; with ``device``
    each process gets ``--device DEVICE``.  Returns the records of the
    whole campaign (earlier runs included on ``resume``)."""
    # admission budget (parity: libs/s10/src/admission.rs S10_MAX_INFLIGHT)
    budget = os.environ.get("S10_MAX_INFLIGHT")
    if budget:
        workers = min(workers, max(1, int(budget)))
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    lock = CampaignLock(out_dir)
    manifest_path = out_dir / "campaign.manifest.json"

    mc_cfg = config.get("monte_carlo", config) if isinstance(config, dict) else {}
    quality = dict(mc_cfg.get("quality", {}))
    retention = dict(mc_cfg.get("retention", {}))

    try:
        rows = materialize_plan(config, out_dir / "plan.csv")
        done: set[str] = set()
        if resume and manifest_path.exists():
            manifest = json.loads(manifest_path.read_text())
            done = set(manifest.get("completed", []))
            rows = [r for r in rows if r["run_id"] not in done]

        port_names = port_names or []
        records = []
        sampler = ResourceSampler(out_dir)
        started = threading.Semaphore(0)

        def staggered_run(i, row):
            # stagger worker starts so N sims don't all hit compile/IO at
            # the same instant (reference worker stagger, lib.rs:1456)
            time.sleep(stagger_s * (i % max(workers, 1)))
            return _run_one(
                sim_path, row, out_dir, max_ticks, port_names, timeout,
                quality, retention, sampler, device,
            )

        records_log = out_dir / "records.jsonl"
        if not resume and records_log.exists():
            records_log.unlink()  # fresh campaign: don't merge stale runs
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futures = [
                pool.submit(staggered_run, i, row)
                for i, row in enumerate(rows)
            ]
            for f in futures:
                rec = f.result()
                records.append(rec)
                done.add(rec["run_id"])
                with open(records_log, "a") as lf:
                    lf.write(json.dumps(rec) + "\n")
                manifest_path.write_text(
                    json.dumps({"completed": sorted(done)}, indent=2)
                )
        sampler.stop()

        # results.csv/perf.csv/summary.json must cover the WHOLE campaign,
        # including runs completed by earlier (resumed-over) invocations —
        # merge the append-only records log, last record per run_id wins
        merged: dict[str, dict] = {}
        if records_log.exists():
            for line in records_log.read_text().splitlines():
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                merged[r.get("run_id", "")] = r
        for r in records:
            merged[r["run_id"]] = r
        records = list(merged.values())

        if records:
            results_path = out_dir / "results.csv"
            fieldnames = sorted({k for r in records for k in r})
            with open(results_path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=fieldnames)
                w.writeheader()
                w.writerows(records)
            # perf.csv: per-run pacing/throughput metrics (lib.rs:1290)
            perf_fields = [
                "run_id", "wall_s", "ticks", "real_time_factor",
                "behind_deadline_frac", "degraded", "valid", "exit_code",
            ]
            with open(out_dir / "perf.csv", "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=perf_fields,
                                   extrasaction="ignore")
                w.writeheader()
                w.writerows(records)

        n_valid = sum(1 for r in records if r.get("valid"))
        n_degraded = sum(1 for r in records if r.get("degraded"))
        n_passed = sum(
            1 for r in records if r.get("valid") and not r.get("degraded")
        )
        summary = {
            "total": len(records),
            "valid": n_valid,
            "invalid": len(records) - n_valid,
            "degraded": n_degraded,
            "passed": n_passed,
            "wall_s": sum(r.get("wall_s", 0.0) for r in records),
        }
        (out_dir / "summary.json").write_text(json.dumps(summary, indent=2))
        if quality.get("fail_on_degraded") and n_degraded:
            raise RuntimeError(
                f"{n_degraded} runs degraded by pacing-integrity gates"
            )
        return records
    finally:
        lock.release()
