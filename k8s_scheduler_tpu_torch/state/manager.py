"""DurableState (the port's copy of `k8s_scheduler_tpu/state/manager.py`):
wires the journal into a live queue/cache, restores, snapshots, seals.

Lifecycle (the CLI, cmd/main.py, drives it):

    state = DurableState(state_dir, snapshot_interval_seconds=60)
    # Scheduler.__init__ calls:
    state.attach(queue, cache)      # restore snapshot+tail, then start
                                    # journaling every mutation
    # per cycle (Scheduler.schedule_cycle):
    state.maybe_snapshot()          # interval-gated compaction
    # SIGTERM:
    state.seal()                    # clean-shutdown snapshot + close

Restore exactness: every journal record carries the clock value `t` the
live mutation used; replay swaps the queue/cache clock for a replay
clock pinned to each record's `t` and re-executes the logical op, so
derived state (backoff expiries = t + backoff(attempts), TTL deadlines
= t + ttl, attempt counts from pop replay) is reproduced bit-identically
— the differential tests assert digest equality over randomized traces.

Snapshot consistency: the dump and the journal cut happen while holding
BOTH the queue and cache locks (lock order queue -> cache -> journal
buffer; no other code path takes two of these at once), so the cut is
an exact point in the op sequence — every op is either inside the
snapshot or in the replay tail, never both, never neither.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time as _time
from typing import Callable

from .codec import (
    node_from_state,
    pod_from_state,
)
from .journal import (
    BATCH_OP,
    Journal,
    StateCorruption,
    StateError,
    encode_batch_payload,
    iter_batch,
    replay_dir,
)
from .snapshot import (
    prune_snapshots,
    read_latest_snapshot,
    snapshot_indices,
    write_snapshot,
)

log = logging.getLogger("k8s_scheduler_tpu_torch.state")


class _ReplayClock:
    """now() callable pinned to the journal record being replayed."""

    __slots__ = ("t",)

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


class DurableState:
    def __init__(
        self,
        state_dir: str,
        *,
        snapshot_interval_seconds: float = 60.0,
        max_segment_bytes: int = 8 << 20,
        fsync: bool = True,
        metrics=None,  # SchedulerMetrics | None
        now: Callable[[], float] = _time.monotonic,
    ) -> None:
        self.dir = state_dir
        os.makedirs(state_dir, exist_ok=True)
        # compile-regime cache lifecycle rides the state dir: the
        # persistent executable cache (core/compile_cache.py) lives in
        # a sibling subtree so a standby that wins the lease inherits
        # the active's compiled programs along with its queue/cache
        # state. Path only — CompileCache.__init__ mkdirs when the
        # Scheduler actually wires it here (compileCacheDir may point
        # elsewhere or disable the cache, and an empty never-used
        # directory next to the journal would mislead restart triage).
        self.compile_cache_path = os.path.join(state_dir, "compile_cache")
        self.snapshot_interval = snapshot_interval_seconds
        self._now = now
        self._metrics = metrics
        # segment numbering floor: after a seal prunes every wal file,
        # a fresh journal must number from the snapshot's journal_from
        # upward or its records would sit below the restore tail
        snaps = snapshot_indices(state_dir)
        self.journal = Journal(
            state_dir,
            max_segment_bytes=max_segment_bytes,
            fsync=fsync,
            metrics=metrics,
            min_index=snaps[-1] if snaps else 0,
        )
        self._queue = None
        self._cache = None
        self._last_snapshot_at = now()
        self.last_snapshot: dict = {}
        self.last_restore: dict = {}
        # per-op Counter children memoized so the hot emit path does one
        # dict hit, not a labels() lookup
        self._append_counters: dict = {}
        # batch group-append state (see batch()): while a batch is open,
        # emissions from the OWNING thread buffer here and flush as ONE
        # journal record on exit. Lock order: _batch_lock is taken only
        # below the queue/cache instance locks (inside a mutator's emit)
        # or with neither held (batch exit) — never the other way, so it
        # cannot invert the queue -> cache order snapshot() relies on.
        self._batch_lock = threading.Lock()
        self._batch_owner: int | None = None
        self._batch_buf: list = []
        self._closed = False

    # ---- wiring ----------------------------------------------------------

    def attach(self, queue, cache) -> dict:
        """Restore whatever the state dir holds into (queue, cache), then
        start journaling their mutations. Returns the restore stats.
        Must run before the first scheduling cycle (the standby-takeover
        point of the CLI: lease won -> Scheduler constructed ->
        attach -> first cycle)."""
        self._queue = queue
        self._cache = cache
        stats = self.restore_into(queue, cache)
        queue.set_journal(self._emit)
        cache.set_journal(self._emit)
        return stats

    def _emit(self, op: str, t: float, data: dict) -> None:
        if self._batch_owner is not None:  # racy pre-check; re-checked
            with self._batch_lock:
                owner = self._batch_owner
                if owner == threading.get_ident():
                    # the batch owner's emission: defer into the group
                    self._batch_buf.append((op, t, data))
                    return
                if owner is not None:
                    # a FOREIGN thread emitting while the serve thread's
                    # batch is open: flush the buffered prefix first so
                    # the journal keeps the true emission order (this
                    # record really did land after everything buffered
                    # so far — emits happen inside the mutators, in
                    # lock-acquisition order)
                    self._flush_batch_locked()
        self._append_record(op, t, data)

    def _append_record(self, op: str, t: float, data: dict) -> None:
        try:
            self.journal.append(op, t, data)
        except StateCorruption:
            raise
        except Exception as e:  # journal writer died (e.g. disk full):
            # durability is lost but serving must not be — detach the
            # emitters (degrade to the pre-durability stateless mode),
            # shout once, and keep the failure visible in status()
            log.error(
                "durable state DISABLED mid-run (%s); scheduler "
                "continues stateless — a takeover will restore only "
                "the last durable prefix", e,
            )
            # detach with PLAIN attribute stores, not set_journal(): the
            # caller holds one instance lock (we are inside a queue or
            # cache mutator) and taking the OTHER object's lock here
            # would invert the queue->cache order snapshot() relies on
            # (ABBA deadlock with a concurrent snapshot). An atomic ref
            # swap is all the readers need.
            if self._queue is not None:
                self._queue._journal = None
            if self._cache is not None:
                self._cache._journal = None
            self._closed = True  # schedlint: disable=TR001 -- monotonic latch: every writer stores True, readers tolerate one stale False (one extra append attempt on a dead writer); no lock needed for an idempotent one-way transition
            return
        m = self._metrics
        if m is not None:
            c = self._append_counters.get(op)
            if c is None:
                c = self._append_counters[op] = m.journal_appends.labels(
                    op=op
                )
            c.inc()

    # ---- batch group-append ----------------------------------------------

    def _flush_batch_locked(self) -> None:
        """Append the buffered batch as one record (callers hold
        _batch_lock). One buffered op degenerates to a plain record —
        same bytes a batchless emit would have written."""
        ops = self._batch_buf
        if not ops:
            return
        self._batch_buf = []  # schedlint: disable=TR001 -- every caller holds _batch_lock (documented contract in the docstring: _emit, batch() exit, snapshot, detach all take it first); the lint cannot see caller-held locks
        if len(ops) == 1:
            op, t, data = ops[0]
            self._append_record(op, t, data)
            return
        # the record's own t is the newest sub-op's clock; replay never
        # reads it (each sub-op carries its own t)
        self._append_record(BATCH_OP, ops[-1][1], encode_batch_payload(ops))
        m = self._metrics
        if m is not None and not self._closed:
            # keep per-logical-op append counters meaningful for folded
            # ops too (op="batch" counted once by _append_record above
            # is the record count; these are the logical-op counts)
            for op, _t, _d in ops:
                c = self._append_counters.get(op)
                if c is None:
                    c = self._append_counters[op] = (
                        self._metrics.journal_appends.labels(op=op)
                    )
                c.inc()

    @contextlib.contextmanager
    def batch(self):
        """Group-append scope for the vectorized apply/bind fold: every
        journal emission from the CALLING thread inside the scope
        coalesces into ONE batch record, appended on exit — one record,
        one buffer push, one share of the group-commit fsync per cycle
        instead of N. Replay expands the batch with each sub-op's own
        clock value, so restored state is bit-identical to N single
        records (tests/test_state_journal.py asserts the digests).

        Emissions from OTHER threads (informer/admission paths) while a
        batch is open first flush the buffered prefix, preserving true
        emission order. Re-entrant and closed-state safe: a nested or
        detached batch() is a transparent no-op."""
        tid = threading.get_ident()
        with self._batch_lock:
            mine = self._batch_owner is None and not self._closed
            if mine:
                self._batch_owner = tid
        try:
            yield
        finally:
            if mine:
                with self._batch_lock:
                    try:
                        self._flush_batch_locked()
                    finally:
                        self._batch_owner = None

    # ---- restore ---------------------------------------------------------

    def restore_into(self, queue, cache) -> dict:
        """Load the latest snapshot (if any) and replay the journal tail,
        leaving (queue, cache) in the exact pre-crash state. Journaling
        and metrics observers are suppressed during replay — a restore
        must not re-journal itself or inflate intake counters."""
        t0 = _time.perf_counter()
        snap = read_latest_snapshot(self.dir)
        from_idx = 0
        clean = False
        if snap is not None:
            queue.load_state(snap["queue"])
            cache.load_state(snap["cache"])
            from_idx = int(snap["journal_from"])
            clean = bool(snap.get("clean_shutdown", False))
        clock = _ReplayClock()
        saved = (
            queue._now, cache._now,
            queue._journal, cache._journal,
            queue._on_enqueue,
        )
        queue._now = cache._now = clock
        queue._journal = cache._journal = None
        queue._on_enqueue = lambda q, e: None
        replayed = 0
        try:
            for op, t, data in replay_dir(self.dir, from_idx):
                if op == BATCH_OP:
                    # expand the group-append: each sub-op replays under
                    # ITS OWN clock value, exactly as N singles would
                    for sub_op, sub_t, sub_d in iter_batch(data):
                        clock.t = sub_t
                        self._apply(queue, cache, sub_op, sub_d)
                    replayed += 1
                    continue
                clock.t = t
                self._apply(queue, cache, op, data)
                replayed += 1
        finally:
            (
                queue._now, cache._now,
                queue._journal, cache._journal,
                queue._on_enqueue,
            ) = saved
        seconds = _time.perf_counter() - t0
        self.last_restore = {
            "snapshot": snap is not None,
            "clean_shutdown": clean,
            "journal_from": from_idx,
            "records_replayed": replayed,
            "seconds": round(seconds, 6),
            "pending": dict(queue.pending_counts()),
            "cache": dict(cache.counts()),
        }
        m = self._metrics
        if m is not None:
            m.restore_records.set(replayed)
            m.restore_duration.set(seconds)
        if snap is not None or replayed:
            log.info(
                "durable state restored: snapshot=%s replayed=%d records "
                "in %.3fs (pending=%s cache=%s)",
                snap is not None, replayed, seconds,
                self.last_restore["pending"], self.last_restore["cache"],
            )
        return self.last_restore

    @staticmethod
    def _apply(queue, cache, op: str, d: dict) -> None:
        """Re-execute one logical mutation. Unknown ops are refused —
        they mean the journal was written by a newer build whose ops
        this one cannot reproduce."""
        if op == "q.add":
            queue.add(pod_from_state(d["pod"]))
        elif op == "q.update":
            queue.update(pod_from_state(d["pod"]))
        elif op == "q.delete":
            queue.delete(d["uid"])
        elif op == "q.pop":
            queue.pop_ready(hold=bool(d.get("hold")))
        elif op == "q.unsched":
            queue.requeue_unschedulable(
                pod_from_state(d["pod"]), reasons=tuple(d.get("reasons", ()))
            )
        elif op == "q.backoff":
            queue.requeue_backoff(
                pod_from_state(d["pod"]), event=d.get("event", "BindError")
            )
        elif op == "q.flush_backoff":
            queue.flush_backoff()
        elif op == "q.flush_timeout":
            queue.flush_unschedulable_timeout()
        elif op == "q.move":
            queue.move_all_to_active_or_backoff(d["event"])
        elif op == "q.recover":
            queue.recover_in_flight()
        elif op == "q.retire":
            queue.retire_in_flight(d["uids"])
        elif op == "c.add_node":
            cache.add_node(node_from_state(d["node"]))
        elif op == "c.update_node":
            cache.update_node(node_from_state(d["node"]))
        elif op == "c.remove_node":
            cache.remove_node(d["name"])
        elif op == "c.add_pod":
            cache.add_pod(pod_from_state(d["pod"]), d["node"])
        elif op == "c.remove_pod":
            cache.remove_pod(d["uid"])
        elif op == "c.assume":
            cache.assume(pod_from_state(d["pod"]), d["node"])
        elif op == "c.finish_binding":
            cache.finish_binding(d["uid"])
        elif op == "c.confirm":
            cache.confirm(d["uid"])
        elif op == "c.forget":
            cache.forget(d["uid"])
        elif op == "c.expire":
            cache.cleanup_expired()
        else:
            raise StateCorruption(
                f"unknown journal op {op!r} — written by a newer build? "
                "(same format version, unrecognized operation)"
            )

    # ---- snapshots -------------------------------------------------------

    def maybe_snapshot(self) -> bool:
        """Interval-gated snapshot; the Scheduler calls this once per
        cycle (off the per-profile hot path)."""
        if self.snapshot_interval <= 0 or self._closed:
            return False
        if self._now() - self._last_snapshot_at < self.snapshot_interval:
            return False
        self.snapshot()
        return True

    def snapshot(self, clean_shutdown: bool = False) -> str:
        """Dump queue+cache at a journal cut, write durably, prune the
        compacted segments and older snapshots."""
        if self._queue is None or self._cache is None:
            raise StateCorruption("snapshot before attach()")
        t0 = _time.perf_counter()
        # consistent cut: both state locks held across dump + cut (see
        # module docstring for the lock-order argument)
        with self._queue._lock:
            with self._cache._lock:
                # flush any open batch prefix first: its mutations are
                # already applied (hence inside the dump below) and the
                # flush lands their record BEFORE the cut — otherwise a
                # post-cut batch record would replay ops the snapshot
                # already contains (double-apply). The emitters are
                # blocked on the two locks we hold, so nothing new can
                # buffer between this flush and the cut.
                with self._batch_lock:
                    self._flush_batch_locked()
                qstate = self._queue.dump_state()
                cstate = self._cache.dump_state()
                tail_from = self.journal.cut()
                t_mono = (
                    self._queue._now()
                    if callable(self._queue._now) else _time.monotonic()
                )
        payload = {
            "format_version": 1,
            "taken_mono": t_mono,
            "taken_wall": _time.time(),
            "clean_shutdown": bool(clean_shutdown),
            "journal_from": tail_from,
            "queue": qstate,
            "cache": cstate,
        }
        path, nbytes = write_snapshot(self.dir, payload)
        # drain the writer before pruning: records for pre-cut segments
        # may still sit in its buffer, and pruning first would let it
        # recreate a just-deleted segment file (harmless for restore —
        # the snapshot covers those ops — but it leaks stale segments
        # and skews the segment gauge). A dead writer skips the barrier:
        # nothing will be written, pruning is safe.
        try:
            self.journal.flush()
        except StateError:
            pass
        # only after the snapshot is durable may its inputs disappear
        self.journal.prune(tail_from)
        prune_snapshots(self.dir, tail_from)
        seconds = _time.perf_counter() - t0
        self._last_snapshot_at = self._now()  # schedlint: disable=TR001 -- httpserver reaches snapshot() only through the by-name fallback on 'snapshot' (the debug routes call FlightRecorder.snapshot); the sole real caller is the serve loop via maybe_snapshot/seal
        self.last_snapshot = {  # schedlint: disable=TR001 -- same fallback inventory as the line above; single-writer in practice
            "path": path,
            "bytes": nbytes,
            "journal_from": tail_from,
            "seconds": round(seconds, 6),
            "clean_shutdown": bool(clean_shutdown),
        }
        m = self._metrics
        if m is not None:
            m.snapshot_writes.inc()
            m.snapshot_duration.observe(seconds)
            m.snapshot_bytes.set(nbytes)
        return path

    def ack_barrier(self, timeout: float = 10.0) -> bool:
        """WAL-before-ack durability barrier (service/admission.py):
        block until every journal record appended so far — in
        particular the q.add records the caller just emitted — is
        fsynced, sharing the writer's group commit with every other
        waiter. Returns False when durability is off or already lost
        (sealed, detached, or the writer died): the ack then goes out
        with `durable: false` instead of blocking on a dead journal."""
        if self._closed or self.journal.failed is not None:
            return False
        try:
            self.journal.flush(timeout=timeout, upto=self.journal.seq())
        except StateError:
            return False
        return True

    def flush_seq(self) -> int:
        """The journal's current append sequence — the group-commit
        flush seq a just-returned ack_barrier rode. Stamped as the
        `flush_seq` attr on ack.barrier trace spans (core/spans) so
        concurrent submitters that shared one fsync are visibly joined
        to it."""
        return self.journal.seq()

    def detach(self) -> None:
        """Stop journaling: drop the queue/cache emitters (plain
        attribute stores — see _emit for the lock-order argument) and
        mark this state closed. Used by the degradation ladder's
        `stateless` rung after seal(): the process keeps serving with
        no durability, and the sealed snapshot is what a standby
        restores."""
        with self._batch_lock:
            self._flush_batch_locked()
            self._batch_owner = None
        if self._queue is not None:
            self._queue._journal = None
        if self._cache is not None:
            self._cache._journal = None
        self._closed = True  # schedlint: disable=TR001 -- monotonic latch (see _append_record): idempotent one-way True store

    def seal(self) -> None:
        """Clean shutdown: final snapshot (so the next start replays
        nothing), flush, close. Safe to call twice."""
        if self._closed:
            return
        self._closed = True  # schedlint: disable=TR001 -- monotonic latch (see _append_record): idempotent one-way True store
        try:
            if self._queue is not None and self.journal.failed is None:
                self.snapshot(clean_shutdown=True)
        finally:
            try:
                self.journal.flush()
            except StateError:
                pass  # writer already dead; close() still joins it
            self.journal.close()

    # ---- observability ---------------------------------------------------

    def status(self) -> dict:
        """The /debug/state payload."""
        out = {
            "state_dir": self.dir,
            "snapshot_interval_s": self.snapshot_interval,
            "journal": self.journal.status(),
            "last_snapshot": dict(self.last_snapshot),
            "last_restore": dict(self.last_restore),
            "sealed": self._closed,
        }
        cc = getattr(self, "compile_cache", None)
        if cc is not None:
            # the Scheduler pins its CompileCache here after wiring so
            # /debug/state shows hit/miss/entry counts next to the
            # journal the same directory holds
            out["compile_cache"] = cc.status()
        deg = getattr(self, "degradation", None)
        if deg is not None:
            # the Scheduler pins its DegradationLadder here: the current
            # rung belongs next to the durability it can seal away —
            # plus the full transition ring (wall-timestamped), so MTTR
            # is computable over HTTP instead of from logs
            out["degradation"] = deg.status()
            out["degradation"]["transition_log"] = deg.transition_log()
        shard = getattr(self, "sharding", None)
        if shard is not None:
            # the Scheduler pins its mesh layout + per-profile
            # collective-payload probe here (same pattern): operators
            # triaging cross-device traffic read it off /debug/state
            out["sharding"] = {
                k: (dict(v) if isinstance(v, dict) else v)
                for k, v in shard.items()
            }
        return out
