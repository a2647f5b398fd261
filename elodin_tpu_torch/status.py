"""`python -m elodin_tpu_torch.status` — neofetch-style host/accelerator/DB
status banner.

Parity: fsw/aleph-status/src/main.rs — the reference prints a logo, OS info,
HW info, then live sensor + SoC telemetry subscribed from the local
elodin-db.  This keeps the section layout and adds an "Accelerators"
section (the CUDA cards and their memory in use, from ``torch.cuda``) in
place of the Jetson SoC rows; sensor rows come from the freshest components
in the DB.

A host-only copy of ``elodin_tpu/status.py``:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import os
import platform
import sys

_COLORS = {
    "green": "\x1b[32m", "yellow": "\x1b[33m", "purple": "\x1b[35m",
    "blue": "\x1b[34m", "cyan": "\x1b[36m",
}
_BOLD, _RESET = "\x1b[1m", "\x1b[0m"


def _tty() -> bool:
    return sys.stdout.isatty() and os.environ.get("NO_COLOR") is None


def _bar(color: str) -> str:
    return f"{_COLORS[color]}▌{_RESET}" if _tty() else "|"


def _header(text: str, color: str) -> None:
    if _tty():
        print(f"{_COLORS[color]}▌\x1b[7m{_BOLD} {text} {_RESET}")
    else:
        print(f"| == {text} ==")


def _row(color: str, key: str, value) -> None:
    k = f"{_COLORS[color]}{_BOLD}{key}{_RESET}" if _tty() else key
    print(f"{_bar(color)} {k} {value}")


def print_os_info() -> None:
    _header("OS Info", "green")
    _row("green", "OS", f"{platform.system()} {platform.release()}")
    _row("green", "Python", platform.python_version())
    try:
        from . import __version__ as ver
    except Exception:
        ver = "dev"
    _row("green", "Framework", f"elodin-tpu {ver}")


def print_hw_info() -> None:
    _header("HW Info", "yellow")
    _row("yellow", "CPU Cores", os.cpu_count() or "N/A")
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    kb = int(line.split()[1])
                    _row("yellow", "RAM", f"{kb / 1e6:.3f}GB")
                    break
    except OSError:
        _row("yellow", "RAM", "N/A")


def print_accelerators() -> None:
    """The CUDA cards in place of the reference's SoC telemetry section."""
    _header("Accelerators", "blue")
    try:
        import torch

        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    except Exception as e:
        _row("blue", "torch", f"unavailable ({e})")
        return
    _row("blue", "Backend", "cuda" if count else "none")
    _row("blue", "Devices", count)
    for i in range(min(count, 8)):
        desc = torch.cuda.get_device_name(i)
        try:
            free, total = torch.cuda.mem_get_info(i)
            desc += f"  HBM {(total - free) / 1e9:.2f}/{total / 1e9:.2f} GB"
        except RuntimeError:
            pass
        _row("blue", f"  [{i}]", desc)


def print_db_status(addr: str) -> bool:
    _header("Telemetry DB", "purple")
    try:
        from .db import Client

        client = Client.connect(addr)
    except Exception:
        _row("purple", "DB", f"not reachable at {addr}")
        return False
    try:
        comps = client.components()
        _row("purple", "Address", addr)
        _row("purple", "Components", len(comps))
        earliest = client.earliest_timestamp()
        _row("purple", "Earliest", f"{earliest} us")
        # freshest few components double as the "Sensors" section
        fresh = []
        for name in list(comps)[:64]:
            s = client.latest(name)
            if s is not None:
                fresh.append(s)
        fresh.sort(key=lambda s: -s.timestamp_us)
        for s in fresh[:6]:
            vals = s.values.reshape(-1)[:6]
            body = ", ".join(f"{float(v):.4g}" for v in vals)
            more = ", …" if s.values.size > 6 else ""
            _row("purple", s.name, f"[{body}{more}]")
        return True
    except Exception as e:  # noqa: BLE001
        # connected but the exchange died (shutdown race, old server):
        # report, don't crash the status banner with a traceback
        _row("purple", "DB", f"unreachable mid-query at {addr}: {e}")
        return False
    finally:
        client.close()


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        prog="elodin-status",
        description="host / accelerator / telemetry-DB status banner",
    )
    p.add_argument("--db-addr", default="127.0.0.1:2240")
    p.add_argument("--no-db", action="store_true")
    args = p.parse_args(argv)

    print()
    _header("ℵ elodin-tpu", "cyan")
    print()
    print_os_info()
    print()
    print_hw_info()
    print()
    print_accelerators()
    if not args.no_db:
        print()
        print_db_status(args.db_addr)
    print()


if __name__ == "__main__":
    main()
