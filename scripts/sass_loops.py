#!/usr/bin/env python3
"""Count the instructions in each loop of a CUDA kernel's SASS.

    python3 scripts/sass_loops.py LIB.so [--kernel SUBSTRING] [--top N]
    python3 scripts/sass_loops.py DUMP.sass ...

Reads ``cuobjdump -sass`` of a shared library (it runs cuobjdump from
``$CUDA_HOME/bin`` or the PATH), or a saved dump.  For every function whose
name holds ``--kernel``, every loop (a branch back to a lower address; the
loop is the address range from its target to the branch) is printed with
its instruction count and the count of each class: FP32 (F*: FADD, FMUL,
FFMA, FSETP, FSEL, FMNMX...), FP64 (D*), MUFU (the SFU), shared-memory
loads (LDS), and the rest.  ``ops`` counts a pipe's arithmetic the way
the published peaks do: an FMA (FFMA, DFMA) as 2, every other FP32 or
FP64 instruction as 1.  ``loop_counts`` is the importable form;
``ptxas_resources`` reads the registers and spills of each function from
ptxas's report (``nvcc -Xptxas -v``).
"""

import argparse
import os
import re
import shutil
import subprocess
import sys
from collections import Counter

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_USED = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_BRA = re.compile(r"\b(?:BRA|BRX)\b[^0-9x]*(0x[0-9a-f]+)")


def _cuobjdump() -> str:
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return path if os.path.isfile(path) else (shutil.which("cuobjdump") or "cuobjdump")


def sass_text(path: str) -> str:
    """SASS of a shared library (through cuobjdump), or a saved dump."""
    if path.endswith(".sass") or path.endswith(".txt"):
        with open(path) as f:
            return f.read()
    return subprocess.run([_cuobjdump(), "-sass", path], capture_output=True, text=True,
                          check=True, timeout=300).stdout


def _functions(text: str):
    """{name: [(address, opcode, operands)]}"""
    out, name = {}, None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _INSN.match(line)
        if m and name is not None:
            out[name].append((int(m.group(1), 16), m.group(3), m.group(4)))
    return out


def _klass(op: str) -> str:
    base = op.split(".")[0]
    if base == "MUFU":
        return "MUFU"
    if base in ("LDS", "LDSM"):
        return "LDS"
    if base.startswith("D") and base[:4] in ("DADD", "DMUL", "DFMA", "DSET", "DMNM"):
        return "FP64"
    if base[:4] in ("FADD", "FMUL", "FFMA", "FSET", "FSEL", "FMNM", "FCHK", "FRND", "FSWZ"):
        return "FP32"
    return "other"


def _ops(op: str) -> int:
    base = op.split(".")[0]
    return 2 if base in ("FFMA", "DFMA") else 1


def loop_counts(text: str, kernel: str = ""):
    """[(function, start, end, instructions, Counter of classes, fp32 ops,
    fp64 ops, Counter of opcodes)] for every loop of every function whose
    name holds ``kernel``."""
    loops = []
    for name, insns in _functions(text).items():
        if kernel not in name:
            continue
        for addr, op, rest in insns:
            m = _BRA.search(op + rest) if op.startswith(("BRA", "BRX")) else None
            if not m:
                continue
            target = int(m.group(1), 16)
            if target >= addr:
                continue
            body = [(a, o) for a, o, _ in insns if target <= a <= addr]
            classes = Counter(_klass(o) for _, o in body)
            fp32 = sum(_ops(o) for _, o in body if _klass(o) == "FP32")
            fp64 = sum(_ops(o) for _, o in body if _klass(o) == "FP64")
            loops.append((name, target, addr, len(body), classes, fp32, fp64,
                          Counter(o.split(".")[0] for _, o in body)))
    return loops


def ptxas_resources(log: str, kernel: str = ""):
    """{function: (registers, spill store bytes, spill load bytes)} of every
    entry function whose name holds ``kernel``, from ptxas's report."""
    out, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = _SPILL.search(line)
        if m and name is not None:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = _USED.search(line)
        if m and name is not None:
            if kernel in name:
                out[name] = (int(m.group(1)), *spill)
            name = None
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path")
    parser.add_argument("--kernel", default="")
    parser.add_argument("--top", type=int, default=12, help="opcodes shown per loop")
    args = parser.parse_args()
    for name, start, end, n, classes, fp32, fp64, opcodes in loop_counts(
            sass_text(args.path), args.kernel):
        print(f"{name} loop 0x{start:x}-0x{end:x}: {n} instructions, "
              + ", ".join(f"{k} {v}" for k, v in sorted(classes.items()))
              + f"; FP32 ops {fp32}, FP64 ops {fp64}; "
              + ", ".join(f"{k} {v}" for k, v in opcodes.most_common(args.top)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
