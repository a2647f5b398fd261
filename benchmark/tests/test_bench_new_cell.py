"""A configuration, a cell and an entry arrive as new files and new entries
in BENCHMARK.json alone.  In a copy of the benchmark, a second n-body cell
on a new entry (``exec_copy``, a copy of ``entries/exec.py`` with its fault
file) and a four-chip cell of a new configuration pass the spec, run and
program-span tests, with no file of the benchmark edited; without the new
entry's fault file the spec test fails and names it."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark.harness.spec import BENCH_DIR, ROOT

NEW_CONFIG = "nbody_copy"
# cell: (configuration, entry, chips)
NEW_CELLS = {"nbody.second": ("nbody", "exec_copy", 1),
             "nbody_copy.four-chips": (NEW_CONFIG, "exec", 4)}
# each cell's cases in the three files: its form, the command without a
# card, a sound run, three faults, a call left out, the control, a traced run
CASES = 9
TESTS = ["benchmark/tests/test_bench_spec.py", "benchmark/tests/test_bench_runs.py",
         "benchmark/tests/test_bench_program_spans.py"]
# the copy's own cells are tested where they live; here only what arrives
NOT_THE_OLD_CELLS = "not leo6dof.rollout-8k and not nbody.fold-8k"


def _files(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _copy_with_new_cells(dest):
    """The benchmark copied to ``dest`` with the new configuration, cells and
    entry added as files, and their entries appended to BENCHMARK.json."""
    bench = dest / "benchmark"
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", ".pytest_cache"))
    before = _files(bench)
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    old = json.loads(json.dumps(spec))

    conf = json.loads((bench / "configs" / "nbody.json").read_text())
    conf["name"] = NEW_CONFIG
    (bench / "configs" / f"{NEW_CONFIG}.json").write_text(json.dumps(conf, indent=2))
    shutil.copy(bench / "configs" / "nbody.py", bench / "configs" / f"{NEW_CONFIG}.py")
    spec["configs"].append(dict({c["name"]: c for c in spec["configs"]}["nbody"],
                                name=NEW_CONFIG, file=f"benchmark/configs/{NEW_CONFIG}.json"))

    shutil.copy(bench / "entries" / "exec.py", bench / "entries" / "exec_copy.py")
    shutil.copy(bench / "tests" / "faults" / "exec.py", bench / "tests" / "faults" / "exec_copy.py")

    template = json.loads((bench / "workloads" / "nbody.fold-8k.json").read_text())
    for name, (config, entry, chips) in NEW_CELLS.items():
        why = f"a copy of nbody.fold-8k on config {config}, entry {entry}, {chips} chips"
        cell = dict(template, config=config, entry=entry, chips=chips, why=why)
        (bench / "workloads" / f"{name}.json").write_text(json.dumps(cell, indent=2))
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": name.split(".", 1)[1], "chips": chips, "why": why})
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))

    after = _files(bench)
    assert {p: h for p, h in after.items() if p in before} == before  # nothing edited
    assert sorted(str(p) for p in set(after) - set(before)) == sorted(
        [f"configs/{NEW_CONFIG}.json", f"configs/{NEW_CONFIG}.py", "entries/exec_copy.py",
         "tests/faults/exec_copy.py"] + [f"workloads/{n}.json" for n in NEW_CELLS])
    for key, entries in old.items():  # BENCHMARK.json only gained entries
        assert spec[key] == entries if not isinstance(entries, list) \
            else spec[key][:len(entries)] == entries
    return bench


def _pytest(dest, files, timeout):
    """``pytest`` on ``files`` in the copy at ``dest``, on the CPU, in four
    workers of one thread each (a cell's ``unchanged`` fault alone takes
    ~3 minutes: its window's calls do no work, and the reference then
    follows every tick they counted); the port is imported from this
    checkout."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider", "-p", "no:randomly",
         "-p", "xdist", "-n", "4", "-k", NOT_THE_OLD_CELLS, *files], cwd=dest, env=env,
        capture_output=True, text=True, timeout=timeout)


def test_a_new_cell_entry_and_configuration_arrive_as_files_only(tmp_path):
    _copy_with_new_cells(tmp_path)
    out = _pytest(tmp_path, TESTS, timeout=900)
    assert out.returncode == 0, out.stdout[-8000:] + out.stderr[-2000:]
    passed = [line for line in out.stdout.splitlines() if line.endswith("PASSED")
              or " PASSED " in line]
    for name in NEW_CELLS:
        assert sum(f"[{name}" in line for line in passed) == CASES, (name, out.stdout[-8000:])
    assert any("test_four_chips_only_for_a_quarter_of_the_cells" in line for line in passed)


def test_a_new_entry_without_its_fault_file_fails_the_spec(tmp_path):
    bench = _copy_with_new_cells(tmp_path)
    (bench / "tests" / "faults" / "exec_copy.py").unlink()
    out = _pytest(tmp_path, TESTS[:1], timeout=300)
    assert out.returncode != 0
    failed = [line for line in out.stdout.splitlines() if line.startswith("FAILED")]
    assert len(failed) == 1, out.stdout[-8000:]
    assert "test_bench_spec.py::test_cell_files_parse[nbody.second]" in failed[0], failed
    assert "no tests/faults/exec_copy.py" in out.stdout, out.stdout[-8000:]
