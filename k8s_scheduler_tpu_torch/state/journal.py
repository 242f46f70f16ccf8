"""Write-ahead journal: checksummed records, rotated segments, group fsync
(the port's copy of `k8s_scheduler_tpu/state/journal.py`: the same wire
format, byte for byte, so either package replays the other's journal).

Wire format (little-endian). Every segment file starts with a fixed
16-byte header:

    [8s magic "TPUSWAL\\0"][u32 format_version][u32 crc32(magic+version)]

followed by length-prefixed records:

    [u32 payload_len][u32 crc32(payload)][payload]

where payload is compact JSON `{"op": str, "t": float, "d": {...}}` —
`t` is the emitting clock (CLOCK_MONOTONIC) value the mutation used, so
replay can re-execute the operation under a replay clock and reproduce
backoff expiries / TTL deadlines exactly.

Append path: `append()` pushes the UNENCODED (op, t, payload) onto an
in-memory buffer — no JSON, no CRC, no I/O, no fsync; just a deque
append under the buffer condition variable (~5us with a pod payload,
dominated by building the payload dict itself). This is safe because
every payload dict is built fresh at emit time (state/codec converters)
and never mutated afterwards. A dedicated writer thread drains the
buffer, encodes, writes each batch with ordinary buffered writes, and
issues ONE fsync per drained batch (group commit) — mirroring how the
serving pipeline keeps only decision bytes synchronous. `flush()` is
the durability barrier (blocks until everything appended so far is
fsynced).

Segments rotate at `max_segment_bytes`, and `cut()` rotates on demand
for snapshot compaction: it returns the index of the first segment that
will hold post-cut records, so a snapshot taken at the cut replays
exactly the tail `>= cut`. A crashed process's torn final record is
detected by length/CRC at replay and discarded — never partially
applied; a segment whose tail is torn simply ends there (the records
after a torn tail were never acknowledged as durable). A segment
written by a FUTURE format version is refused with a clear error
instead of being misparsed.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import re
import struct
import sys
import threading
import time as _time
import zlib

log = logging.getLogger("k8s_scheduler_tpu_torch.state")


def _fault_hook(point: str) -> None:
    """Fault-injection bridge (core/faults.py) without importing the
    core package: resolved through sys.modules, so a restore-only
    Journal (standby, tooling, tests) never imports the scheduler's
    modules — arming requires the faults module to be imported already, and unarmed cost
    is one dict lookup per writer batch (never the append path)."""
    mod = sys.modules.get("k8s_scheduler_tpu_torch.core.faults")
    if mod is not None and mod.ARMED:
        mod.raise_enospc(point)

SEGMENT_MAGIC = b"TPUSWAL\x00"
FORMAT_VERSION = 1

_HEADER = struct.Struct("<8sI")  # magic, version (crc32 of these follows)
_CRC = struct.Struct("<I")
_FRAME = struct.Struct("<II")  # payload_len, crc32(payload)
_SEG_RE = re.compile(r"^wal-(\d{8})\.seg$")


class StateError(RuntimeError):
    """Base error for the durable-state layer."""


class StateCorruption(StateError):
    """Non-torn-tail damage: bad magic, unknown op, unreadable snapshot."""


class StateVersionError(StateError):
    """Journal/snapshot written by a newer format version than this build."""


def segment_header(version: int = FORMAT_VERSION) -> bytes:
    body = _HEADER.pack(SEGMENT_MAGIC, version)
    return body + _CRC.pack(zlib.crc32(body))


def encode_record(op: str, t: float, data: dict) -> bytes:
    payload = json.dumps(
        {"op": op, "t": t, "d": data}, separators=(",", ":")
    ).encode()
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


# Batch record: ONE journal record carrying N logical sub-operations —
# the group-append the vectorized apply/bind fold emits per cycle
# (core/scheduler._apply_phase under DurableState.batch()). The wire
# shape is an ordinary record whose op is BATCH_OP and whose payload is
# {"ops": [[op, t, d], ...]}: each sub-op keeps its OWN clock value, so
# replay pins the replay clock per sub-record and reproduces the exact
# state N single records would (the digest-equivalence contract
# tests/test_state_journal.py asserts). Because the batch is one frame,
# a crash tears it ATOMICALLY — a torn tail discards the whole cycle's
# fold, never a prefix of it (the per-record CRC covers all sub-ops).
BATCH_OP = "batch"

# Tenancy journal ops (the reference's tenancy/registry.py; ROADMAP A12 in
# the port): a TenantRegistry journals every virtual-cluster mutation — lifecycle (create/suspend/resume/
# delete), membership (node/pod adds, removals), and binds — under
# "tn."-prefixed ops into its OWN Journal directory, using this exact
# wire format and the same emit-once clock discipline.
# The streams never mix by construction: DurableState.restore_into
# refuses unknown ops, and restore_registry refuses non-tn ops, so a
# misconfigured shared directory fails loudly on the first replay
# instead of silently cross-applying records.
TENANCY_OP_PREFIX = "tn."
TENANCY_OPS = (
    "tn.create", "tn.suspend", "tn.resume", "tn.delete",
    "tn.node", "tn.pod", "tn.unpod", "tn.bind",
)


def encode_batch_payload(ops: list) -> dict:
    """Payload dict for a batch record from [(op, t, data), ...]."""
    return {"ops": [[op, t, data] for op, t, data in ops]}


def iter_batch(data: dict):
    """Yield (op, t, data) sub-records of a batch record's payload —
    the replay-side inverse of encode_batch_payload (used by
    DurableState.restore_into and the state tooling)."""
    for op, t, d in data.get("ops", ()):
        yield op, t, d or {}


def segment_path(directory: str, index: int) -> str:
    return os.path.join(directory, f"wal-{index:08d}.seg")


def segment_indices(directory: str) -> list[int]:
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    out = []
    for n in names:
        m = _SEG_RE.match(n)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def read_segment(path: str):
    """Yield (op, t, data) records from one segment. A torn tail (short
    frame, short payload, or CRC mismatch on the FINAL record of a
    crashed writer) ends iteration cleanly — the torn bytes were never
    acknowledged durable, so discarding them is the correct replay. A
    wrong magic raises StateCorruption; a future format version raises
    StateVersionError (replaying guesses against an unknown format is
    how state gets silently mangled)."""
    with open(path, "rb") as f:
        blob = f.read()
    hsize = _HEADER.size + _CRC.size
    if len(blob) < hsize:
        # header itself torn: the segment was created but nothing ever
        # became durable in it
        return
    magic, version = _HEADER.unpack_from(blob, 0)
    (crc,) = _CRC.unpack_from(blob, _HEADER.size)
    if magic != SEGMENT_MAGIC:
        raise StateCorruption(
            f"{path}: bad segment magic {magic!r} (not a journal segment)"
        )
    if crc != zlib.crc32(blob[: _HEADER.size]):
        # torn header write: treat as an empty segment
        return
    if version > FORMAT_VERSION:
        raise StateVersionError(
            f"{path}: journal format version {version} is newer than this "
            f"build supports (<= {FORMAT_VERSION}); refusing to replay — "
            "upgrade the scheduler or discard the state directory"
        )
    off = hsize
    n = len(blob)
    while True:
        if off + _FRAME.size > n:
            if off < n:
                log.warning(
                    "%s: torn frame header at byte %d discarded", path, off
                )
            return  # torn frame header at EOF
        length, crc = _FRAME.unpack_from(blob, off)
        start = off + _FRAME.size
        end = start + length
        if end > n:
            log.warning(
                "%s: torn final record at byte %d discarded", path, off
            )
            return  # torn payload at EOF
        payload = blob[start:end]
        if zlib.crc32(payload) != crc:
            if end < n:
                # a crash tear can only sit at EOF (every batch is
                # fsynced before it is acknowledged, and a segment is
                # synced before rotation opens the next): a bad record
                # FOLLOWED BY MORE BYTES is real damage to acknowledged
                # data — refuse to replay a stream with a hole in it
                raise StateCorruption(
                    f"{path}: record at byte {off} fails CRC with "
                    f"{n - end} bytes following — mid-segment "
                    "corruption of acknowledged records; restore from "
                    "a replica or discard the state directory"
                )
            log.warning(
                "%s: torn final record at byte %d discarded", path, off
            )
            return  # torn tail: discard, never partially apply
        rec = json.loads(payload)
        yield rec["op"], rec["t"], rec.get("d") or {}
        off = end


def replay_dir(directory: str, from_index: int = 0):
    """Yield (op, t, data) across all segments >= from_index, in order."""
    for idx in segment_indices(directory):
        if idx < from_index:
            continue
        yield from read_segment(segment_path(directory, idx))


class Journal:
    """The append side: buffered records, writer thread, group fsync.

    A restarted process never appends into an old segment (whose tail
    may be torn): construction allocates a fresh segment index past
    everything on disk, and replay handles old torn tails read-side.
    """

    def __init__(
        self,
        directory: str,
        *,
        max_segment_bytes: int = 8 << 20,
        fsync: bool = True,
        metrics=None,  # SchedulerMetrics | None
        min_index: int = 0,
    ) -> None:
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        existing = segment_indices(directory)
        self._cond = threading.Condition()
        self._buf: collections.deque = collections.deque()
        # the index current appends are destined for; its file is opened
        # lazily by the writer on the first record. Indices in the buffer
        # are monotonic (assigned under the cond at append; bumped under
        # the cond by cut() and by the writer's size rotation), so the
        # FIFO writer never switches back to an older segment.
        # `min_index` is the floor the OWNER derives from the newest
        # snapshot's journal_from: after a seal prunes every wal file,
        # numbering must NOT restart at 0 below the snapshot — restore
        # replays only segments >= journal_from, so records written
        # under a lower index would be silently skipped forever.
        self._cur_index = max(
            (existing[-1] + 1) if existing else 0, min_index
        )
        self._cur_count = 0
        self._max = max_segment_bytes
        self._appended = 0
        self._durable = 0
        self._stopped = False
        # set when the writer thread dies on an I/O error (ENOSPC, EIO):
        # durability is over for this Journal — append()/flush() raise so
        # the owner (DurableState._emit) can degrade loudly instead of
        # buffering into an unbounded, never-drained deque
        self.failed: str | None = None
        # writer poll cadence / forced-wake depth (see append())
        self._poll_s = 0.02
        self._wake_depth = 4096
        self._do_fsync = fsync
        self._metrics = metrics
        self._fh = None
        self._open_index: int | None = None
        self._open_bytes = 0
        self.bytes_written = 0
        self.last_fsync_s = 0.0
        self.fsync_count = 0
        # the writer thread starts LAZILY on the first append: a
        # restore-only Journal (standbys before attach, tooling reading
        # the dir, tests) must not leave a polling thread behind
        self._writer: threading.Thread | None = None

    # ---- append path (the hot side: no I/O) -----------------------------

    def append(self, op: str, t: float, data: dict) -> int:
        """Buffer one record; returns its sequence number. Never blocks
        on disk and never encodes — JSON+CRC framing happens on the
        writer thread (durability via flush(), the explicit barrier).
        `data` must be a freshly built dict the caller will not mutate
        (the state/codec converters guarantee this)."""
        with self._cond:
            if self._stopped:
                raise StateError("journal is closed")
            if self.failed is not None:
                raise StateError(f"journal writer failed: {self.failed}")
            if self._writer is None:
                self._writer = threading.Thread(
                    target=self._run, name="journal-writer", daemon=True
                )
                self._writer.start()
            self._buf.append((self._cur_index, op, t, data))
            self._cur_count += 1
            self._appended += 1
            seq = self._appended
            # do NOT notify per record: waking the writer mid-burst makes
            # it encode concurrently with the scheduling thread and the
            # GIL contention lands on the bind path (measured ~4x the
            # append cost). The writer polls on a short timeout instead,
            # so encoding happens while the scheduler waits on device
            # transfers (GIL released). Only a deep buffer forces a wake.
            if len(self._buf) >= self._wake_depth:
                self._cond.notify()
        return seq

    def cut(self) -> int:
        """Rotate so that every record appended from now on lands in a
        new segment; returns that segment's index — the snapshot's
        `journal_from`. The caller must hold whatever locks stop
        concurrent emitters (DurableState.snapshot holds the queue and
        cache locks), so the cut is a consistent point in the op
        sequence."""
        with self._cond:
            if self._cur_count:
                self._cur_index += 1
                self._cur_count = 0
            return self._cur_index

    def flush(
        self, timeout: float | None = 30.0, upto: int | None = None
    ) -> None:
        """Durability barrier: returns once everything appended before
        the call has been written and fsynced. `upto` narrows the
        barrier to a specific append sequence (the value a prior
        `append()` returned) — the WAL-before-ack path in
        service/admission.py waits only for ITS records, so concurrent
        submitters share one group-commit fsync instead of serializing
        behind each other's tails."""
        deadline = None if timeout is None else _time.monotonic() + timeout
        with self._cond:
            target = self._appended if upto is None else min(
                upto, self._appended
            )
            self._cond.notify()  # expedite past the writer's poll cadence
            while self._durable < target:
                if self.failed is not None:
                    raise StateError(
                        f"journal writer failed: {self.failed}"
                    )
                if self._stopped and not self._buf:
                    return
                remaining = None
                if deadline is not None:
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        raise StateError(
                            f"journal flush timed out ({target - self._durable}"
                            " records undrained)"
                        )
                self._cond.wait(remaining)

    def seq(self) -> int:
        """Sequence number of the newest append so far — the `upto`
        target a caller passes to flush() to wait for exactly the
        records it just emitted."""
        with self._cond:
            return self._appended

    def close(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        if self._writer is not None:
            self._writer.join(timeout=30)
            if self._writer.is_alive():
                # writer wedged on a stalled disk: do NOT touch the
                # file object it may still be writing to — closing it
                # under the writer would tear a record mid-frame. The
                # fd leaks with the (daemon) thread; the segment's torn
                # tail is handled at the next replay.
                log.error(
                    "journal writer failed to drain within 30s at "
                    "close; leaving its segment open (torn tail will "
                    "be discarded at next restore)"
                )
                return
            self._writer = None
        if self._fh is not None:
            self._sync_open()
            self._fh.close()
            self._fh = None

    def prune(self, before_index: int) -> int:
        """Delete segments wholly superseded by a durable snapshot."""
        removed = 0
        for idx in segment_indices(self.dir):
            if idx < before_index:
                try:
                    os.unlink(segment_path(self.dir, idx))
                    removed += 1
                except FileNotFoundError:
                    pass
        self._note_segments()
        return removed

    def status(self) -> dict:
        with self._cond:
            buffered = len(self._buf)
            appended = self._appended
            durable = self._durable
            cur = self._cur_index
        return {
            "segments": len(segment_indices(self.dir)),
            "current_segment": cur,
            "failed": self.failed,
            "appended": appended,
            "durable": durable,
            "buffered": buffered,
            "bytes_written": self.bytes_written,
            "last_fsync_ms": round(self.last_fsync_s * 1e3, 3),
            "fsync_count": self.fsync_count,
            "fsync": self._do_fsync,
        }

    # ---- writer thread ---------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._buf and not self._stopped:
                    self._cond.wait(self._poll_s)
                    if self._buf or self._stopped:
                        break
                batch = list(self._buf)
                self._buf.clear()
                stopped = self._stopped
            if batch:
                try:
                    self._write_batch(batch)
                except Exception as e:
                    # I/O failure (ENOSPC, EIO, ...): durability cannot
                    # be promised any further — fail LOUDLY and
                    # permanently rather than buffering forever or
                    # risking duplicate records from blind retries of a
                    # possibly-partially-written batch (replay exactness
                    # beats best-effort persistence here)
                    log.exception(
                        "journal writer died; durability disabled "
                        "(%d records lost from this batch, %d still "
                        "buffered)", len(batch), len(self._buf),
                    )
                    try:
                        if self._fh is not None:
                            self._fh.close()
                    except OSError:
                        pass
                    self._fh = None
                    with self._cond:
                        self.failed = f"{type(e).__name__}: {e}"
                        self._cond.notify_all()
                    return
                with self._cond:
                    self._durable += len(batch)
                    self._cond.notify_all()
                m = self._metrics
                if m is not None:
                    m.journal_buffer.set(len(self._buf))
            if stopped and not batch:
                return

    def _write_batch(self, batch: list[tuple[int, str, float, dict]]) -> None:
        # `journal_enospc` injection point: raises ENOSPC exactly where
        # a full disk would, driving the real writer-death path (_run's
        # handler -> failed flag -> DurableState degrades to stateless)
        _fault_hook("journal_enospc")
        wrote = 0
        for idx, op, t, data in batch:
            rec = encode_record(op, t, data)
            if idx != self._open_index:
                if self._fh is not None:
                    self._sync_open()
                    self._fh.close()
                self._fh = open(segment_path(self.dir, idx), "ab")
                if self._fh.tell() == 0:
                    self._fh.write(segment_header())
                self._open_index = idx
                self._open_bytes = 0
                self._note_segments()
            self._fh.write(rec)
            self._open_bytes += len(rec)
            wrote += len(rec)
        if self._fh is not None:
            self._sync_open()
        if self._open_bytes > self._max:
            # size rotation, decided writer-side with REAL byte counts:
            # bump the append index so the next record opens a fresh
            # segment (unless a cut already bumped past us)
            with self._cond:
                if self._cur_index == self._open_index:
                    self._cur_index += 1
                    self._cur_count = 0
        self.bytes_written += wrote
        m = self._metrics
        if m is not None:
            m.journal_bytes.inc(wrote)

    def _sync_open(self) -> None:
        """One flush+fsync for everything written since the last sync —
        the group-commit point (runs ONLY on the writer thread)."""
        self._fh.flush()
        if not self._do_fsync:
            return
        t0 = _time.perf_counter()
        os.fsync(self._fh.fileno())
        self.last_fsync_s = _time.perf_counter() - t0
        self.fsync_count += 1
        m = self._metrics
        if m is not None:
            m.journal_fsync.observe(self.last_fsync_s)

    def _note_segments(self) -> None:
        m = self._metrics
        if m is not None:
            m.journal_segments.set(len(segment_indices(self.dir)))
