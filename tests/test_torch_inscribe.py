"""The port's disk-image flasher (``elodin_tpu_torch.inscribe``), on the
CPU: the eight cases of ``tests/test_inscribe.py`` (ten with their
parameters) on the port's copy: disk discovery parse, streamed flash with
decompression, read-back verify, the CLI's guards.  Then the port held to
the JAX package's ``inscribe`` on the same inputs: the disks it offers,
the bytes, ``written``, ``sha256``, progress and verdict of a flash of
raw, gz and xz images onto an empty and onto a longer device, the verdict
on a corrupted device, and a decompressor that dies mid-stream.  They
write only to files the test makes."""

import gzip
import hashlib
import json
import lzma
import os

import numpy as np
import pytest

from elodin_tpu import inscribe as jinscribe
from elodin_tpu_torch import inscribe


LSBLK = json.dumps({
    "blockdevices": [
        {"name": "nvme0n1", "path": "/dev/nvme0n1", "size": 512000000000,
         "rm": False, "type": "disk", "mountpoints": ["/"], "model": "SSD",
         "tran": "nvme"},
        {"name": "sda", "path": "/dev/sda", "size": 32000000000, "rm": True,
         "type": "disk", "mountpoints": [None], "model": "USB Flash ",
         "tran": "usb",
         "children": [{"name": "sda1", "path": "/dev/sda1",
                       "type": "part", "mountpoints": ["/media/usb"]}]},
        {"name": "sdb", "path": "/dev/sdb", "size": 64000000000,
         "rm": False, "type": "disk", "mountpoints": [None],
         "model": "Ext HDD", "tran": "usb"},
        {"name": "loop0", "path": "/dev/loop0", "size": 4096, "rm": False,
         "type": "loop", "mountpoints": [None]},
    ]
})


def test_list_external_disks_parse():
    disks = inscribe.list_external_disks(LSBLK)
    paths = [d["path"] for d in disks]
    # internal nvme root disk and loop devices are never offered
    assert paths == ["/dev/sda", "/dev/sdb"]
    sda = disks[0]
    assert sda["name"] == "USB Flash"
    assert sda["size"] == 32000000000
    # child partition mountpoints are surfaced for auto-unmount
    assert sda["mountpoints"] == ["/media/usb"]


@pytest.mark.parametrize("comp", ["raw", "gz", "xz"])
def test_flash_roundtrip(tmp_path, comp):
    payload = os.urandom(700_000)  # > 2 chunks
    if comp == "raw":
        img = tmp_path / "image.img"
        img.write_bytes(payload)
    elif comp == "gz":
        img = tmp_path / "image.img.gz"
        img.write_bytes(gzip.compress(payload))
    else:
        img = tmp_path / "image.img.xz"
        img.write_bytes(lzma.compress(payload))
    dest = tmp_path / "device"
    seen = []
    res = inscribe.flash(str(img), str(dest), progress=seen.append)
    assert dest.read_bytes() == payload
    assert res["written"] == len(payload)
    assert res["sha256"] == hashlib.sha256(payload).hexdigest()
    assert seen and seen[-1] == len(payload)
    assert inscribe.verify(str(dest), res["sha256"], res["written"])


def test_flash_overwrites_in_place_like_a_block_device(tmp_path):
    """Block devices cannot be truncated: a shorter image over a longer
    'device' must leave the tail bytes in place (write-in-place)."""
    dest = tmp_path / "device"
    dest.write_bytes(b"\xff" * 1000)
    img = tmp_path / "img"
    img.write_bytes(b"\x00" * 100)
    inscribe.flash(str(img), str(dest))
    data = dest.read_bytes()
    assert len(data) == 1000
    assert data[:100] == b"\x00" * 100 and data[100:] == b"\xff" * 900


def test_verify_detects_corruption(tmp_path):
    dest = tmp_path / "device"
    img = tmp_path / "img"
    img.write_bytes(os.urandom(5000))
    res = inscribe.flash(str(img), str(dest))
    raw = bytearray(dest.read_bytes())
    raw[123] ^= 0xFF
    dest.write_bytes(raw)
    assert not inscribe.verify(str(dest), res["sha256"], res["written"])


def test_cli_force_file_target_with_verify(tmp_path, capsys):
    img = tmp_path / "img"
    img.write_bytes(os.urandom(10_000))
    dest = tmp_path / "dev"
    rc = inscribe.main([str(img), "--disk", str(dest), "--force", "--yes",
                        "--verify"])
    assert rc == 0
    assert dest.read_bytes() == img.read_bytes()
    assert "verify: OK" in capsys.readouterr().err


def test_cli_refuses_non_external_target_without_force(tmp_path):
    img = tmp_path / "img"
    img.write_bytes(b"x")
    with pytest.raises(SystemExit):
        inscribe.main([str(img), "--disk", str(tmp_path / "dev"), "--yes"])


def test_zst_corrupt_archive_raises(tmp_path, monkeypatch):
    """A decompressor that dies mid-stream must FAIL the flash: its pipe
    just ends early, so without checking the exit code a truncated image
    would be written and --verify would still pass (it hashes only the
    bytes actually written)."""
    # fake `zstd` that emits some bytes then exits nonzero (corrupt archive)
    bindir = tmp_path / "bin"
    bindir.mkdir()
    fake = bindir / "zstd"
    fake.write_text("#!/bin/sh\nhead -c 100000 /dev/zero\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")

    img = tmp_path / "image.img.zst"
    img.write_bytes(b"not really zstd")
    dest = tmp_path / "device"
    dest.write_bytes(b"")
    with pytest.raises(inscribe.InscribeError, match="corrupt/truncated"):
        inscribe.flash(str(img), str(dest))


def test_zst_clean_archive_flashes(tmp_path, monkeypatch):
    """Happy path through the subprocess decompressor (exit 0)."""
    payload = b"A" * 300_000
    bindir = tmp_path / "bin"
    bindir.mkdir()
    fake = bindir / "zstd"
    # fake decompressor: emits the 'decompressed' payload from a side file
    src = tmp_path / "payload.bin"
    src.write_bytes(payload)
    fake.write_text(f"#!/bin/sh\ncat {src}\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")

    img = tmp_path / "image.img.zst"
    img.write_bytes(b"opaque")
    dest = tmp_path / "device"
    dest.write_bytes(b"")
    out = inscribe.flash(str(img), str(dest))
    assert out["written"] == len(payload)
    assert dest.read_bytes() == payload
    assert out["sha256"] == hashlib.sha256(payload).hexdigest()


def _image(tmp_path, comp, payload):
    """``payload`` written as a raw, gz or xz image."""
    if comp == "raw":
        img = tmp_path / "image.img"
        img.write_bytes(payload)
    elif comp == "gz":
        img = tmp_path / "image.img.gz"
        img.write_bytes(gzip.compress(payload))
    else:
        img = tmp_path / "image.img.xz"
        img.write_bytes(lzma.compress(payload))
    return img


def test_list_external_disks_matches_the_jax_package():
    assert inscribe.list_external_disks(LSBLK) == jinscribe.list_external_disks(LSBLK)


@pytest.mark.parametrize("device", ["empty", "longer"])
@pytest.mark.parametrize("comp", ["raw", "gz", "xz"])
def test_flash_matches_the_jax_package(tmp_path, comp, device):
    """One image flashed by both packages onto the same device: the same
    bytes on the device (a longer device keeps its tail in both), the same
    ``written``, ``sha256`` and progress, and both verify it."""
    payload = np.random.default_rng(16).bytes(700_000)  # > 2 chunks
    img = _image(tmp_path, comp, payload)
    got = {}
    for label, mod in (("jax", jinscribe), ("torch", inscribe)):
        dest = tmp_path / f"{label}.dev"
        if device == "longer":
            dest.write_bytes(b"\xa5" * 1_000_000)
        seen = []
        res = mod.flash(str(img), str(dest), progress=seen.append)
        got[label] = (dest.read_bytes(), res["written"], res["sha256"], seen,
                      mod.verify(str(dest), res["sha256"], res["written"]))
    assert got["torch"] == got["jax"]
    assert got["torch"][0][:len(payload)] == payload
    assert len(got["torch"][0]) == (1_000_000 if device == "longer" else len(payload))


def test_verify_of_a_corrupted_device_matches_the_jax_package(tmp_path):
    img = tmp_path / "img"
    img.write_bytes(np.random.default_rng(16).bytes(5000))
    dest = tmp_path / "device"
    res = inscribe.flash(str(img), str(dest))
    assert res["sha256"] == jinscribe.flash(str(img), str(tmp_path / "jdevice"))["sha256"]
    raw = bytearray(dest.read_bytes())
    raw[123] ^= 0xFF
    dest.write_bytes(raw)
    verdicts = [mod.verify(str(dest), res["sha256"], res["written"])
                for mod in (jinscribe, inscribe)]
    assert verdicts == [False, False]


def test_zst_corrupt_archive_raises_as_in_the_jax_package(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    fake = bindir / "zstd"
    fake.write_text("#!/bin/sh\nhead -c 100000 /dev/zero\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    img = tmp_path / "image.img.zst"
    img.write_bytes(b"not really zstd")
    errors = []
    for label, mod in (("jax", jinscribe), ("torch", inscribe)):
        dest = tmp_path / f"{label}.dev"
        dest.write_bytes(b"")
        with pytest.raises(mod.InscribeError) as e:
            mod.flash(str(img), str(dest))
        errors.append((str(e.value), dest.read_bytes()))
    assert errors[0] == errors[1]
