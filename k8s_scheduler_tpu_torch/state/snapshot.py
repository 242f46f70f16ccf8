"""Atomic whole-state snapshots that compact the write-ahead journal (the
port's copy of `k8s_scheduler_tpu/state/snapshot.py`, the same format).

A snapshot file is the full durable state (queue tiers + cache) at a
journal cut, so restore = load snapshot + replay segments
`>= journal_from`. Format:

    [8s magic "TPUSSNP\\0"][u32 format_version][u32 crc32(payload)]
    [u32 payload_len][payload JSON]

Written crash-safely: temp file in the same directory, fsync, atomic
rename onto `snap-<journal_from>.snap`, fsync the directory. A crash
mid-write leaves only an ignorable temp file; a crash after rename has
the complete new snapshot. Older snapshots and the journal segments
they covered are pruned only after the new snapshot is durable.
"""

from __future__ import annotations

import os
import re
import struct
import zlib

from .journal import (
    FORMAT_VERSION,
    StateCorruption,
    StateVersionError,
)

SNAPSHOT_MAGIC = b"TPUSSNP\x00"
_HEAD = struct.Struct("<8sIII")  # magic, version, crc32(payload), len
_SNAP_RE = re.compile(r"^snap-(\d{8})\.snap$")

# json import deferred to call sites would save nothing; keep it simple
import json  # noqa: E402


def snapshot_path(directory: str, journal_from: int) -> str:
    return os.path.join(directory, f"snap-{journal_from:08d}.snap")


def snapshot_indices(directory: str) -> list[int]:
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    return sorted(
        int(m.group(1)) for m in (_SNAP_RE.match(n) for n in names) if m
    )


def write_snapshot(directory: str, payload: dict) -> tuple[str, int]:
    """Serialize + write the snapshot durably; returns (path, bytes).
    `payload["journal_from"]` names the first journal segment NOT
    compacted into this snapshot (the replay tail's start)."""
    body = json.dumps(payload, separators=(",", ":")).encode()
    head = _HEAD.pack(
        SNAPSHOT_MAGIC, FORMAT_VERSION, zlib.crc32(body), len(body)
    )
    final = snapshot_path(directory, int(payload["journal_from"]))
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        f.write(head)
        f.write(body)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    dfd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
    return final, len(head) + len(body)


def read_snapshot(path: str) -> dict:
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < _HEAD.size:
        raise StateCorruption(f"{path}: truncated snapshot header")
    magic, version, crc, length = _HEAD.unpack_from(blob, 0)
    if magic != SNAPSHOT_MAGIC:
        raise StateCorruption(f"{path}: bad snapshot magic {magic!r}")
    if version > FORMAT_VERSION:
        raise StateVersionError(
            f"{path}: snapshot format version {version} is newer than this "
            f"build supports (<= {FORMAT_VERSION}); refusing to restore"
        )
    body = blob[_HEAD.size : _HEAD.size + length]
    if len(body) != length or zlib.crc32(body) != crc:
        raise StateCorruption(
            f"{path}: snapshot payload fails CRC/length check "
            "(torn or corrupted write) — discard the state directory or "
            "restore from a replica"
        )
    return json.loads(body)


def read_latest_snapshot(directory: str) -> dict | None:
    """The newest snapshot, or None when the journal is all there is."""
    idxs = snapshot_indices(directory)
    if not idxs:
        return None
    return read_snapshot(snapshot_path(directory, idxs[-1]))


def prune_snapshots(directory: str, keep_from: int) -> int:
    """Delete snapshots older than the one at `keep_from`."""
    removed = 0
    for idx in snapshot_indices(directory):
        if idx < keep_from:
            try:
                os.unlink(snapshot_path(directory, idx))
                removed += 1
            except FileNotFoundError:
                pass
    return removed
