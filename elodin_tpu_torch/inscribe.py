"""Disk-image flasher — the ``apps/inscriber`` equivalent (counterpart of
``elodin_tpu/inscribe.py``).

The reference (``apps/inscriber/src/main.rs:1-349``) lists
external drives, prompts for one, unmounts it, and streams a (optionally
zstd-compressed) recovery image to the raw device with a progress bar.
This port keeps that surface with safety rails the reference leaves to
the platform tools:

- external-drive discovery via ``lsblk -J`` (removable or USB-attached
  disks only; ``--force`` required to write anywhere else),
- auto-unmount of mounted partitions before writing,
- streamed chunked copy with decompression by extension — ``.gz``/``.xz``
  via the stdlib, ``.zst`` through the ``zstd`` binary when present (no
  zstandard module is vendored),
- a ``--verify`` read-back that SHA-256s the written bytes against the
  image (beyond the reference),
- progress + MB/s on stderr.

Usage::

    python -m elodin_tpu_torch.inscribe image.img[.gz|.xz|.zst] [--disk /dev/sdX]
        [--yes] [--force] [--verify]

A host-only copy: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

CHUNK = 256 * 1024


class InscribeError(RuntimeError):
    pass


def list_external_disks(lsblk_json: str | None = None) -> list[dict]:
    """Removable/USB disks from ``lsblk -J`` (parse is injectable for
    tests).  Returns [{path, name, size, mountpoints}]."""
    if lsblk_json is None:
        proc = subprocess.run(
            ["lsblk", "-J", "-b", "-o",
             "NAME,PATH,SIZE,RM,TYPE,MOUNTPOINTS,MODEL,TRAN"],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise InscribeError(f"lsblk failed: {proc.stderr.strip()}")
        lsblk_json = proc.stdout
    data = json.loads(lsblk_json)
    out = []
    for dev in data.get("blockdevices", []):
        if dev.get("type") != "disk":
            continue
        if not (dev.get("rm") or dev.get("tran") == "usb"):
            continue
        mounts = [m for m in dev.get("mountpoints") or [] if m]
        for child in dev.get("children") or []:
            mounts += [m for m in child.get("mountpoints") or [] if m]
        out.append({
            "path": dev.get("path") or f"/dev/{dev['name']}",
            "name": (dev.get("model") or "").strip() or dev["name"],
            "size": int(dev.get("size") or 0),
            "mountpoints": mounts,
        })
    return out


def unmount_all(disk: dict) -> None:
    for mp in disk.get("mountpoints", []):
        proc = subprocess.run(["umount", mp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise InscribeError(
                f"could not unmount {mp}: {proc.stderr.strip()}")


def _open_image(path: str):
    """(stream, total_compressed_bytes, proc_or_None) with decompression by
    extension.  The zstd path decompresses through a subprocess whose exit
    code MUST be checked after draining: a corrupt/truncated archive ends
    the pipe early with no exception, which would otherwise half-flash the
    destination and still pass --verify (the digest covers only the bytes
    actually written)."""
    total = os.path.getsize(path)
    if path.endswith(".gz"):
        import gzip

        return gzip.open(path, "rb"), total, None
    if path.endswith(".xz"):
        import lzma

        return lzma.open(path, "rb"), total, None
    if path.endswith(".zst"):
        if shutil.which("zstd") is None:
            raise InscribeError(
                ".zst image but no `zstd` binary on PATH (and no "
                "zstandard module is vendored); decompress it first"
            )
        proc = subprocess.Popen(["zstd", "-dcq", path],
                                stdout=subprocess.PIPE)
        return proc.stdout, total, proc
    return open(path, "rb"), total, None


def flash(image: str, dest: str, progress=None) -> dict:
    """Stream `image` onto `dest` (a block device or file opened for
    write-in-place).  Returns {written, sha256, wall_s}."""
    stream, _, proc = _open_image(image)
    sha = hashlib.sha256()
    written = 0
    t0 = time.perf_counter()
    # O_WRONLY without O_TRUNC: block devices cannot be truncated, and a
    # file destination must be overwritten in place the same way
    fd = os.open(dest, os.O_WRONLY | (os.O_CREAT if not
                 os.path.exists(dest) else 0), 0o644)
    try:
        with stream:
            while True:
                chunk = stream.read(CHUNK)
                if not chunk:
                    break
                os.write(fd, chunk)
                sha.update(chunk)
                written += len(chunk)
                if progress:
                    progress(written)
        if proc is not None and proc.wait() != 0:
            raise InscribeError(
                f"decompressor exited {proc.returncode}: the archive is "
                f"corrupt/truncated and only {written} bytes were flashed"
            )
        os.fsync(fd)
    finally:
        os.close(fd)
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
    return {
        "written": written,
        "sha256": sha.hexdigest(),
        "wall_s": time.perf_counter() - t0,
    }


def verify(dest: str, expect_sha256: str, length: int) -> bool:
    """Read back `length` bytes from `dest` and compare digests."""
    sha = hashlib.sha256()
    left = length
    with open(dest, "rb") as f:
        while left > 0:
            chunk = f.read(min(CHUNK, left))
            if not chunk:
                return False
            sha.update(chunk)
            left -= len(chunk)
    return sha.hexdigest() == expect_sha256


def _progress_printer(total_hint: int):
    state = {"last": 0.0, "t0": time.perf_counter()}

    def tick(written: int) -> None:
        now = time.perf_counter()
        if now - state["last"] < 0.25:
            return
        state["last"] = now
        mb = written / 1e6
        rate = mb / max(now - state["t0"], 1e-9)
        pct = f" {100.0 * written / total_hint:5.1f}%" if total_hint else ""
        sys.stderr.write(f"\r  {mb:9.1f} MB{pct}  {rate:7.1f} MB/s")
        sys.stderr.flush()

    return tick


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m elodin_tpu_torch.inscribe",
        description="flash a disk image to an external drive",
    )
    ap.add_argument("image")
    ap.add_argument("--disk", help="target device (else: pick from list)")
    ap.add_argument("--yes", action="store_true",
                    help="skip the confirmation prompt")
    ap.add_argument("--force", action="store_true",
                    help="allow a target that is not a removable/USB disk "
                         "(e.g. a plain file)")
    ap.add_argument("--verify", action="store_true",
                    help="read back and SHA-256-verify the written bytes")
    args = ap.parse_args(argv)

    if not os.path.exists(args.image):
        ap.error(f"image not found: {args.image}")

    disks = list_external_disks()
    disk = None
    if args.disk:
        disk = next((d for d in disks if d["path"] == args.disk), None)
        if disk is None:
            if not args.force:
                ap.error(f"{args.disk} is not an external drive "
                         "(use --force to write anyway)")
            disk = {"path": args.disk, "name": args.disk, "size": 0,
                    "mountpoints": []}
    else:
        if not disks:
            ap.error("no external drives found (pass --disk PATH --force "
                     "to target something else)")
        sys.stderr.write("external drives:\n")
        for i, d in enumerate(disks):
            sys.stderr.write(f"  [{i}] {d['path']}  {d['name']}  "
                             f"{d['size'] / 1e9:.1f} GB\n")
        try:
            sel = int(input("flash which? "))
            disk = disks[sel]
        except (ValueError, IndexError, EOFError):
            ap.error("no valid selection")

    if not args.yes:
        sys.stderr.write(
            f"about to OVERWRITE {disk['path']} ({disk['name']}) with "
            f"{os.path.basename(args.image)} — type 'yes' to continue: "
        )
        if input().strip().lower() != "yes":
            sys.stderr.write("aborted\n")
            return 1

    unmount_all(disk)
    total_hint = os.path.getsize(args.image)
    res = flash(args.image, disk["path"], _progress_printer(total_hint))
    sys.stderr.write(
        f"\nwrote {res['written'] / 1e6:.1f} MB in {res['wall_s']:.1f}s "
        f"({res['written'] / 1e6 / max(res['wall_s'], 1e-9):.1f} MB/s)\n"
    )
    if args.verify:
        ok = verify(disk["path"], res["sha256"], res["written"])
        sys.stderr.write("verify: OK\n" if ok else "verify: MISMATCH\n")
        if not ok:
            return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
