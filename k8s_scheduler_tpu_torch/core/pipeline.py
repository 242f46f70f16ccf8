"""The serving pipeline (`k8s_scheduler_tpu/core/pipeline.py`), single-cycle
half: only the decision bytes block.

One cycle runs as:

    encode (host)                       # caller, before dispatch()
    -> dispatch: upload into slot k%2, carry update, cycle program, the
       decision slimming (i16 assignment when N < 2^15, u8 flag byte per
       pod), all enqueued on the current CUDA stream, and a non_blocking
       copy of the slim payload into a pinned host buffer followed by a
       recorded event
    -> decisions(): wait on that event (the one blocking wait of the
       decision path), through `_FetchWorker` when a deadline is set
    -> winners bind; preemption and diagnosis are dispatched after the
       binds on the same stream (stream order is the ordering guard the
       reference gets from its futures) and forced only when a loser needs
       them.

Two slots double-buffer the inputs: a slot keeps its cycle's device
buffers alive for that cycle's deferred programs while the next cycle
uploads into the other. A host buffer handed to `dispatch(device_put=
True)` goes through the slot's pinned staging pair; the next write into a
slot's staging waits for that slot's last upload event. (The encoder's
`encode_packed` uploads its own frames from its pinned arena, whose next
write waits for the last upload.)

Ordering contract: cycle k's binds fold into the cache before cycle k+1's
encode reads it, so `dispatch()` refuses to start cycle k+1 until cycle
k's decisions were fetched (`require_decision_fetch=False` opts out).
`forced_sync=True` blocks every dispatch to completion: identical results,
no overlap. On the CPU (the tests) every step runs eagerly and a host
buffer is copied before dispatch (`_cpu_safe_buffers`), so a deferred
program never reads an arena the next encode rewrote.

Multi-cycle batches (`dispatch_multi`, `MultiCycleHandle`): K stacked
frames in one dispatch of `core/cycle.build_packed_multicycle_fn`, whose
decisions are slimmed per inner cycle and copied into pinned host memory
row by row, each with its event, so `decisions_row(i)` waits for row i
alone and the apply loop binds cycle i's winners while later rows are in
flight. A batch counts as the in-flight cycle for the ordering guard.
Depth-2 speculation relaxes it: `dispatch_multi(speculative=True,
carry0=...)` dispatches batch B chained on batch A's device-resident carry
while A is unfetched (a third slot holds it); the caller then
`adopt_speculative()`s or `abandon_speculative()`s it. The cycle programs'
own host syncs (the rounds' stop test and the sites PERF.md lists) make a
speculative dispatch return only once B's rounds have run, so speculation
here moves when the host applies, not when the device runs."""

from __future__ import annotations

import threading as _threading
import time as _time

import numpy as np
import torch

from ..utils.device import resolve_device
from . import faults as _faults


class DispatchDeadlineExceeded(RuntimeError):
    """The blocking decision fetch exceeded `dispatchDeadlineMs`: the
    watchdog abandoned the wait (its worker thread keeps waiting until the
    device lets go) so the serve loop can step down the degradation ladder
    and requeue the cycle's pods instead of hanging. The cycle is
    consumed, as by any other failed fetch (the ordering guard
    releases)."""


class _FetchWorker:
    """Deadline bound for a blocking wait the host cannot interrupt (a
    CUDA event's `synchronize`): the wait runs on a reusable daemon
    thread while the serve loop waits with a timeout. On expiry the
    worker is abandoned (told to exit when the wait returns) and the next
    bounded fetch starts a fresh one. The worker launches nothing: it only
    waits."""

    def __init__(self) -> None:
        self._lock = _threading.Lock()
        self._q = None
        self._thread: "_threading.Thread | None" = None

    def _run(self, jobs) -> None:
        while True:
            fn, box, done = jobs.get()
            if fn is None:
                return  # abandoned after a deadline expiry
            try:
                box["v"] = fn()
            except BaseException as e:  # schedlint: disable=RB001 -- not swallowed: delivered whole to the waiting serve thread, which classifies + attributes it
                box["e"] = e
            finally:
                done.set()

    def run(self, fn, deadline_s: float):
        import queue as _queue

        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._q = _queue.Queue()
                self._thread = _threading.Thread(
                    target=self._run, args=(self._q,),
                    name="decision-fetch", daemon=True,
                )
                self._thread.start()
            q = self._q
            box: dict = {}
            done = _threading.Event()
            q.put((fn, box, done))
        if not done.wait(deadline_s):
            with self._lock:
                if self._q is q:
                    q.put((None, None, None))
                    self._thread = None
                    self._q = None
            raise DispatchDeadlineExceeded(
                f"decision fetch exceeded the dispatch deadline "
                f"({deadline_s * 1e3:.0f} ms); transfer abandoned"
            )
        if "e" in box:
            raise box["e"]
        return box["v"]


def build_decision_slim_fn(num_nodes: int):
    """Output slimming for the decision fetch: (assignment i32 [P],
    unschedulable bool [P], gang_dropped bool [P]) -> (assignment
    i16|i32 [P], flags u8 [P]), flags bit0 = unschedulable, bit1 =
    gang_dropped. The i16 narrowing is exact whenever every node index
    (and -1) fits, i.e. N < 2**15. Takes tensors or numpy arrays and
    returns the same kind."""
    narrow = num_nodes < (1 << 15)

    def slim(assignment, unschedulable, gang_dropped):
        if isinstance(assignment, np.ndarray):
            a = assignment.astype(np.int16) if narrow else assignment
            flags = (np.asarray(unschedulable).astype(np.uint8)
                     | (np.asarray(gang_dropped).astype(np.uint8) << 1))
            return a, flags
        a = assignment.to(torch.int16) if narrow else assignment
        flags = unschedulable.to(torch.uint8) | (gang_dropped.to(torch.uint8) << 1)
        return a, flags

    return slim


def build_multicycle_slim_rows_fn(num_nodes: int):
    """The streamed multi-cycle slimming (reference `core/pipeline.py:181`):
    stacked [K, P] decisions in, one (assignment i16|i32 [P], flags u8 [P])
    pair per row out. Flag bits: 0 = unschedulable, 1 = gang_dropped, 2 =
    attempted (the pod was valid in that inner cycle: "not this cycle's
    pod" differs from "placed at node 0"). `build_multicycle_slim_fn`'s
    stacked variant is the same rows stacked."""
    narrow = num_nodes < (1 << 15)

    def slim(assignment, unschedulable, gang_dropped, attempted, rows: int):
        a = assignment.to(torch.int16) if narrow else assignment
        flags = (unschedulable.to(torch.uint8) | (gang_dropped.to(torch.uint8) << 1)
                 | (attempted.to(torch.uint8) << 2))
        return [(a[i], flags[i]) for i in range(rows)]

    return slim


def build_multicycle_slim_fn(num_nodes: int):
    """Stacked multi-cycle slimming (reference `core/pipeline.py:160`):
    (assignment i16|i32 [K, P], flags u8 [K, P], cycles_run)."""
    rows = build_multicycle_slim_rows_fn(num_nodes)

    def slim(assignment, unschedulable, gang_dropped, attempted, cycles_run):
        out = rows(assignment, unschedulable, gang_dropped, attempted, assignment.shape[0])
        return (torch.stack([a for a, _ in out]), torch.stack([f for _, f in out]),
                int(cycles_run))

    return slim


def _cpu_safe_buffers(wbuf, bbuf):
    """Host buffers as tensors the deferred programs may read later: a
    numpy arena (which the next encode rewrites in place) is copied, since
    `torch.from_numpy` would alias it; tensors pass through. The word
    buffer travels as int32 words (`models/packing.unpack`)."""
    if isinstance(wbuf, np.ndarray):
        wbuf = torch.from_numpy(wbuf.view(np.int32).copy())
    if isinstance(bbuf, np.ndarray):
        bbuf = torch.from_numpy(bbuf.copy())
    return wbuf, bbuf


class CycleHandle:
    """One in-flight cycle: the device results plus the host-side fetch
    state. Created by ServingPipeline.dispatch(); the caller blocks only
    in decisions() — everything else resolves lazily."""

    def __init__(self, pipe, result, slim, wbuf, bbuf, stable, emask):
        self._pipe = pipe
        self.result = result  # CycleResult / CycleDecision on the device
        self._slim = slim  # (host i16|i32 [P], host u8 [P], event | None)
        self._wbuf = wbuf
        self._bbuf = bbuf
        self._stable = stable
        self._emask = emask
        self._decisions = None
        self._t_decisions = None
        self._events = None  # the card's (carry start, cycle start, end)
        self._diag = None
        self._pre = None
        self.fetched = False

    # ---- the one blocking fetch -----------------------------------------

    def _wait_slim(self):
        a, flags, ev = self._slim
        if ev is not None:
            ev.synchronize()
        return a.numpy(), flags.numpy()

    def decisions(self):
        """(assignment i32 [P], unschedulable bool [P], gang_dropped
        bool [P]) as numpy — waits for the slim payload's copy only."""
        if self._decisions is None:
            now = self._pipe._now
            t0 = now()
            self._pipe.stats["t_decision_start"] = t0
            try:
                a, flags = self._pipe.fetch_decisions(self._wait_slim)
            except Exception as e:
                # a failed fetch consumes the cycle: the ordering guard
                # releases, and the failure is attributed before re-raise
                self._pipe.note_fetch_failure(e)
                self.fetched = True
                self.release()
                self._pipe._note_inflight()
                raise
            self._t_decisions = now()
            st = self._pipe.stats
            st["decision_wait_ms"] = (self._t_decisions - t0) * 1e3
            if self._events:  # the slim payload's event came after them
                e = self._events
                st["carry_events_ms"] = e[0].elapsed_time(e[1])
                st["cycle_events_ms"] = e[1].elapsed_time(e[2])
            st["t_decision_end"] = self._t_decisions
            st["fetch_bytes"] = int(a.nbytes + flags.nbytes)
            # what the un-slimmed fetch of the same fields would move
            st["fetch_bytes_full"] = int(a.shape[0] * (4 + 1 + 1))
            self._pipe._fetch_bytes_total += st["fetch_bytes"]
            m = self._pipe._metrics
            if m is not None:
                m.cycle_duration.labels(phase="decision_fetch").observe(
                    self._t_decisions - t0
                )
                m.decision_fetch_bytes.inc(st["fetch_bytes"])
            self._decisions = (
                np.asarray(a, dtype=np.int32),
                (flags & 1) != 0,
                (flags & 2) != 0,
            )
            self.fetched = True
            self._pipe._note_inflight()
        return self._decisions

    # ---- deferred (off the bind path) -----------------------------------

    def dispatch_preemption(self):
        """Enqueue the preemption PostFilter program; returns its result
        (device tensors) or None. Called after the winners' binds, so its
        device time overlaps the host bind loop."""
        if self._pre is None and self._pipe._preempt_fn is not None:
            self._pre = self._pipe._preempt_fn(
                self._wbuf, self._bbuf, self.result, self._stable
            )
        return self._pre

    def dispatch_diagnosis(self):
        """Enqueue the FailedScheduling diagnosis program; returns its
        [P, F] device tensor or None when the pipeline has none."""
        if self._diag is None and self._pipe._diag_fn is not None:
            r = self.result
            kw = {}
            pv = getattr(r, "pv_claimed", None)
            if pv is not None:
                kw["pv_claimed"] = pv
            if self._emask is not None:
                kw["emask"] = self._emask
            self._diag = self._pipe._diag_fn(
                self._wbuf, self._bbuf, self._stable,
                r.assignment, r.node_requested, **kw,
            )
            if self._pipe._donate_diagnosis:
                # the slot's buffers go to the diagnosis program, the last
                # consumer: nothing may reference them again
                self._wbuf = self._bbuf = None
            if self._pipe.forced_sync:
                _sync(self._diag)
                if self._t_decisions is not None:
                    t_done = self._pipe._now()
                    self._pipe.stats["diag_lag_ms"] = (
                        t_done - self._t_decisions
                    ) * 1e3
                    self._pipe.stats["t_diag_done"] = t_done
        return self._diag

    def reject_counts(self):
        """Force the diagnosis output (i32 [P, F] numpy); None when no
        diagnosis program exists. Records the diagnosis lag: how long
        after the decision fetch the attribution became available."""
        d = self.dispatch_diagnosis()
        if d is None:
            return None
        arr = d.cpu().numpy()
        if (
            self._t_decisions is not None
            and "t_diag_done" not in self._pipe.stats
        ):
            t_done = self._pipe._now()
            self._pipe.stats["diag_lag_ms"] = (t_done - self._t_decisions) * 1e3
            self._pipe.stats["t_diag_done"] = t_done
        if self._t_decisions is not None:
            m = self._pipe._metrics
            if m is not None:
                m.cycle_duration.labels(phase="diag_lag").observe(
                    self._pipe.stats.get("diag_lag_ms", 0.0) / 1e3
                )
        return arr

    def reject_counts_matrix(self, n: int):
        """The per-plugin attribution as one [n, F] numpy matrix: the
        diagnosis program's, or the full cycle's own `reject_counts` when
        the pipeline has no diagnosis program."""
        rc = self.reject_counts()
        if rc is None:
            rc = self.result.reject_counts.cpu().numpy()
        return np.asarray(rc)[:n]

    def block(self):
        """Wait for everything in flight (the forced_sync path), through
        the same bounded fetch as decisions()."""
        try:
            self._pipe.fetch_decisions(self._block_all)
        except Exception as e:
            self._pipe.note_fetch_failure(e)
            self.fetched = True
            self.release()
            self._pipe._note_inflight()
            raise
        return self

    def _block_all(self):
        _sync(self.result)
        self._wait_slim()

    def release(self):
        """Drop every device reference so the slot's blocks free."""
        self.result = self._slim = self._diag = self._pre = None
        self._wbuf = self._bbuf = self._stable = self._emask = None


class MultiCycleHandle:
    """One in-flight multi-cycle batch (reference `core/pipeline.py:417`):
    the stacked device results and per-row slim payloads. `decisions_row(i)`
    waits for row i's copy alone; the handle counts as fetched (the
    ordering guard releases) once every live row (`n_live`) was fetched.
    Inner cycle i's deferred programs (diagnosis, preemption) run lazily on
    row i of the stacked buffers and the loop's post-cycle-i
    `node_requested`."""

    def __init__(self, pipe, result, slim, wbufs, bbufs, stable, n_live: int,
                 speculative: bool = False):
        self._pipe = pipe
        self.result = result  # MultiCycleResult on the device
        self._slim = slim  # [(host a, host flags, event | None)] per live row
        self._wbufs = wbufs
        self._bbufs = bbufs
        self._stable = stable
        self.n_live = n_live
        self.speculative = speculative
        self._rows: dict[int, tuple] = {}
        self._t_decisions = None
        self._diag: dict[int, object] = {}
        self._pre: dict[int, object] = {}
        # inner cycle i -> (lag_s, t_done): when its attribution became
        # available, stamped at first force
        self.diag_lag: dict[int, tuple[float, float]] = {}
        self._stats_seed: dict = {}
        self.fetched = False

    def _consumed(self, e: BaseException) -> None:
        """A failed fetch consumes the batch: the ordering guard releases
        and the failure class is stamped before the re-raise."""
        self._pipe.note_fetch_failure(e)
        self.fetched = True
        self.release()
        self._pipe._note_inflight()

    def decisions_row(self, i: int):
        """Inner cycle i's decisions as numpy — (assignment i32 [P],
        unschedulable bool [P], gang_dropped bool [P], attempted bool [P])
        — waiting for row i's slim copy only. The first row stamps
        `t_first_decision`."""
        hit = self._rows.get(i)
        if hit is not None:
            return hit
        now = self._pipe._now
        t0 = now()
        st = self._pipe.stats
        st.setdefault("t_decision_start", t0)

        def wait():
            a, flags, ev = self._slim[i]
            if ev is not None:
                ev.synchronize()
            return a.numpy(), flags.numpy()

        try:
            a, flags = self._pipe.fetch_decisions(wait)
        except Exception as e:  # schedlint: disable=RB001 -- not swallowed: _consumed stamps the failure class before the re-raise
            self._consumed(e)
            raise
        t1 = now()
        self._t_decisions = t1
        st["decision_wait_ms"] = st.get("decision_wait_ms", 0.0) + (t1 - t0) * 1e3
        st["t_decision_end"] = t1
        st.setdefault("t_first_decision", t1)
        from . import spans as _spans

        if _spans.ARMED:
            st.setdefault("decision_rows", []).append((i, t0, t1))
        nbytes = int(a.nbytes + flags.nbytes)
        st["fetch_bytes"] = st.get("fetch_bytes", 0) + nbytes
        self._pipe._fetch_bytes_total += nbytes
        m = self._pipe._metrics
        if m is not None:
            m.cycle_duration.labels(phase="decision_fetch").observe(t1 - t0)
            m.decision_fetch_bytes.inc(nbytes)
        row = (np.asarray(a, dtype=np.int32), (flags & 1) != 0, (flags & 2) != 0,
               (flags & 4) != 0)
        self._rows[i] = row
        if len(self._rows) >= self.n_live and not self.fetched:
            self.fetched = True
            self._pipe._note_inflight()
        return row

    def cycles_run(self) -> int:
        """Inner cycles the loop executed (a host count: no transfer)."""
        return int(self.result.cycles_run)

    def decisions(self):
        """(assignment i32 [K, P], unschedulable, gang_dropped, attempted
        bool [K, P], cycles_run) as numpy: every live row, stacked."""
        rows = [self.decisions_row(i) for i in range(self.n_live)]
        K, P = self.result.assignment.shape if self.result is not None else (self.n_live, 0)
        out = [np.full((K, P), -1, np.int32)] + [np.zeros((K, P), bool) for _ in range(3)]
        for i, r in enumerate(rows):
            for o, v in zip(out, r):
                o[i] = v
        return (*out, self.cycles_run())

    def _inner_decision(self, i: int):
        from .cycle import CycleDecision

        r = self.result
        return CycleDecision(assignment=r.assignment[i], node_requested=r.node_requested[i],
                             unschedulable=r.unschedulable[i],
                             gang_dropped=r.gang_dropped[i],
                             placed_round=torch.where(r.assignment[i] >= 0, 0, -1))

    def dispatch_preemption(self, i: int):
        """Enqueue inner cycle i's preemption PostFilter. As in the
        reference, candidates and victims come from the batch-start
        existing set: a pod bound by an earlier inner cycle becomes
        evictable from the next batch on."""
        if i not in self._pre and self._pipe._preempt_fn is not None:
            self._pre[i] = self._pipe._preempt_fn(
                self._wbufs[i], self._bbufs[i], self._inner_decision(i), self._stable)
        return self._pre.get(i)

    def dispatch_diagnosis(self, i: int):
        """Enqueue inner cycle i's FailedScheduling diagnosis (the
        pipeline's `multi_diag_fn`: the batch's decisions are lean)."""
        fn = self._pipe.multi_diag_fn or self._pipe._diag_fn
        if i not in self._diag and fn is not None:
            r = self.result
            self._diag[i] = fn(self._wbufs[i], self._bbufs[i], self._stable,
                               r.assignment[i], r.node_requested[i])
            if self._pipe.forced_sync:
                _sync(self._diag[i])
                self._stamp_diag_lag(i)
        return self._diag.get(i)

    def _stamp_diag_lag(self, i: int) -> None:
        if self._t_decisions is None or i in self.diag_lag:
            return
        t_done = self._pipe._now()
        lag_s = max(0.0, t_done - self._t_decisions)
        self.diag_lag[i] = (lag_s, t_done)
        m = self._pipe._metrics
        if m is not None:
            m.cycle_duration.labels(phase="diag_lag").observe(lag_s)

    def reject_counts(self, i: int):
        d = self.dispatch_diagnosis(i)
        if d is None:
            return None
        arr = d.cpu().numpy()
        self._stamp_diag_lag(i)
        return arr

    def reject_counts_matrix(self, i: int, n: int):
        """Inner cycle i's per-plugin attribution as one [n, F] matrix."""
        return np.asarray(self.reject_counts(i))[:n]

    def block(self):
        """Wait for everything in flight (forced_sync), bounded as a fetch."""
        def wait_all():
            _sync(self.result.assignment)
            for _a, _f, ev in self._slim:
                if ev is not None:
                    ev.synchronize()

        try:
            self._pipe.fetch_decisions(wait_all)
        except Exception as e:
            # a consumed batch: the class stamped, the guard released
            self._pipe.note_fetch_failure(e)
            self.fetched = True
            self.release()
            self._pipe._note_inflight()
            raise
        return self

    def release(self):
        self.result = self._slim = None
        self._wbufs = self._bbufs = self._stable = None
        self._diag = {}
        self._pre = {}
        self.diag_lag = {}


def _sync(x) -> None:
    """Wait for the device work behind `x` (a tensor, a dataclass of
    tensors or None): the current stream's work, on the card."""
    dev = None
    if isinstance(x, torch.Tensor):
        dev = x.device
    else:
        for v in getattr(x, "__dict__", {}).values():
            if isinstance(v, torch.Tensor):
                dev = v.device
                break
    if dev is not None and dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


class ServingPipeline:
    """Owns the two upload slots, the in-flight handle and the carry
    hand-off (`CarryKeeper`). One instance per packed regime — the
    Scheduler memoizes it next to the programs.

    `cycle_fn` is a packed cycle program: the carry path's
    (`build_packed_cycle_carry_fn`, with `keeper`) or the full packed one
    (`build_packed_cycle_fn`, `keeper=None`). `diag_fn` / `preempt_fn`
    are the deferred companions (None disables them). `device` is where
    `dispatch(device_put=True)` uploads host buffers (None = the card)."""

    def __init__(
        self,
        cycle_fn,
        *,
        keeper=None,
        diag_fn=None,
        preempt_fn=None,
        forced_sync: bool = False,
        require_decision_fetch: bool = True,
        donate_diagnosis: bool = False,
        metrics=None,
        events=None,
        dispatch_deadline_s: float = 0.0,
        now=_time.perf_counter,
        slots: int = 2,
        device=None,
    ) -> None:
        if donate_diagnosis and preempt_fn is not None:
            raise ValueError(
                "donate_diagnosis requires preempt_fn=None "
                "(preemption reads the packed buffers after diagnosis)"
            )
        self._cycle_fn = cycle_fn
        self._keeper = keeper
        self._diag_fn = diag_fn
        self._preempt_fn = preempt_fn
        self.forced_sync = forced_sync
        self.require_decision_fetch = require_decision_fetch
        self._donate_diagnosis = donate_diagnosis
        self._metrics = metrics
        self._events = events
        self.dispatch_deadline_s = dispatch_deadline_s
        self._fetch_worker = _FetchWorker()  # no thread until first use
        self._now = now
        self._device = device
        self._slots = [None] * max(2, slots)
        # per slot: pinned host staging (words, bytes) and its last upload
        self._staging: list = [None] * len(self._slots)
        self._uploaded: list = [None] * len(self._slots)
        self._slim_fn = None
        self._multi_slim_fn = None
        # the multi-cycle programs (the Scheduler assigns them per regime):
        # the batch loop, its per-row diagnosis, the carry-in continuation
        self.multi_fn = None
        self.multi_diag_fn = None
        self.multi_cont_fn = None
        self._spec = None  # the in-flight speculative batch
        self.speculation = {"adopted": 0, "abandoned": 0, "redispatched": 0}
        self._last = None
        self._n = 0
        self._fetch_bytes_total = 0
        self._pending_encode_ms: float | None = None
        # per-cycle stage report, refreshed by dispatch() / decisions() /
        # reject_counts(); encode_ms is fed by the caller via note_encode()
        self.stats: dict[str, float] = {}

    @property
    def cycles(self) -> int:
        return self._n

    @property
    def fetch_bytes_total(self) -> int:
        return self._fetch_bytes_total

    def fetch_decisions(self, fn):
        """Run the one blocking wait of the decision path with the fault
        hooks and (when `dispatch_deadline_s` > 0) the watchdog applied.
        `fetch_delay` sleeps OUTSIDE the bounded call (a slow transfer:
        visible latency); `fetch_hang` sleeps INSIDE it (a wedged transfer:
        exactly what the deadline bounds)."""
        if _faults.ARMED:
            _faults.sleep_point("fetch_delay")
            inner = fn

            def fn():
                _faults.sleep_point("fetch_hang")
                return inner()

        d = self.dispatch_deadline_s
        if d and d > 0:
            return self._fetch_worker.run(fn, d)
        return fn()

    def note_fetch_failure(self, e: BaseException) -> str:
        """Attribute a consumed cycle's fetch failure before it re-raises:
        `scheduler_fetch_failures_total{class}` + an events-ring entry.
        Returns the class. Never raises."""
        from .cycle import classify_failure

        cls = (
            "deadline" if isinstance(e, DispatchDeadlineExceeded)
            else classify_failure(e)
        )
        try:
            m = self._metrics
            if m is not None:
                m.fetch_failures.labels(cls).inc()
            ev = self._events
            if ev is not None:
                from .events import FETCH_FAILED

                ev.system(
                    FETCH_FAILED,
                    f"cycle decision fetch failed ({cls}): {e}"[:400],
                )
        except Exception:  # schedlint: disable=RB001 -- deliberately silent: the original error re-raises right after this call and carries the story; attribution must never hold the ordering guard hostage
            pass
        return cls

    def note_encode(self, seconds: float) -> None:
        """Record the host encode time of the snapshot about to be
        dispatched — feeds the overlap accounting in stage_report."""
        self._pending_encode_ms = seconds * 1e3

    def _claim_slot(self) -> int:
        """Claim the next upload slot, releasing its previous occupant's
        device references; refuses to overwrite a slot whose cycle was
        never fetched."""
        slot = self._n % len(self._slots)
        prev = self._slots[slot]
        if prev is not None:
            if not prev.fetched and self.require_decision_fetch:
                raise RuntimeError(
                    f"ServingPipeline: upload slot {slot} still holds "
                    "an unfetched in-flight batch — dispatch depth "
                    f"exceeds the {len(self._slots)}-slot arena"
                )
            prev.release()
        return slot

    def _upload(self, slot: int, wbuf, bbuf):
        """Host buffers -> the device through the slot's pinned staging:
        the write into the staging waits for the slot's last upload, the
        copies are non_blocking and an event marks their end. On the CPU:
        `_cpu_safe_buffers`."""
        dev = resolve_device(self._device)
        wbuf, bbuf = _cpu_safe_buffers(wbuf, bbuf)
        if dev.type != "cuda" or wbuf.device.type == "cuda":
            return wbuf, bbuf
        st = self._staging[slot]
        if st is None or st[0].shape != wbuf.shape or st[1].shape != bbuf.shape:
            # per slot, shaped as the buffers (a multi-cycle batch stacks K)
            st = (torch.empty(wbuf.shape, dtype=torch.int32, pin_memory=True),
                  torch.empty(bbuf.shape, dtype=torch.uint8, pin_memory=True))
            self._staging[slot] = st
        if self._uploaded[slot] is not None:
            self._uploaded[slot].synchronize()
        st[0].copy_(wbuf)
        st[1].copy_(bbuf)
        dw = torch.empty(st[0].shape, dtype=torch.int32, device=dev)
        db = torch.empty(st[1].shape, dtype=torch.uint8, device=dev)
        dw.copy_(st[0], non_blocking=True)
        db.copy_(st[1], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._uploaded[slot] = ev
        return dw, db

    def upload(self, wbuf, bbuf):
        """Upload host buffers into the slot the next `dispatch` claims
        (its pinned staging, after that slot's last upload) and return the
        device buffers, for `dispatch(device_put=False)`: the packed path
        uploads before its stable tables are computed."""
        return self._upload(self._n % len(self._slots), wbuf, bbuf)

    def _fetch_slim(self, a, flags):
        """Enqueue the slim payload's copy into pinned host memory and
        record its event (the card); on the CPU the tensors themselves."""
        if a.device.type != "cuda":
            return a, flags, None
        ha = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
        hf = torch.empty(flags.shape, dtype=flags.dtype, pin_memory=True)
        ha.copy_(a, non_blocking=True)
        hf.copy_(flags, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return ha, hf, ev

    def dispatch(
        self,
        wbuf,
        bbuf,
        stable,
        *,
        dirty=None,
        carry_key=None,
        pin=None,
        emask=None,
        escore=None,
        device_put: bool = True,
    ) -> CycleHandle:
        """Upload + enqueue one cycle; returns at once with a CycleHandle
        (unless forced_sync). Raises if the previous cycle's decisions
        were never fetched while require_decision_fetch. `device_put=False`
        takes device buffers as they are (a numpy arena is still copied:
        `_cpu_safe_buffers`). `pin` is the reference's strong reference
        for its carry key and is not needed here. The carried extender
        verdicts (`emask`, `escore`: `ExtenderVerdictKeeper`'s device
        planes) go to the carry cycle, and `emask` to the diagnosis."""
        del pin
        if (
            self.require_decision_fetch
            and self._last is not None
            and not self._last.fetched
        ):
            raise RuntimeError(
                "ServingPipeline: cycle k+1 dispatched before cycle k's "
                "decisions were fetched — binds cannot have folded before "
                "this snapshot was encoded (pass "
                "require_decision_fetch=False for fold-free loops)"
            )
        t0 = self._now()
        slot = self._claim_slot()
        if device_put:
            wbuf, bbuf = self._upload(slot, wbuf, bbuf)
        else:
            wbuf, bbuf = _cpu_safe_buffers(wbuf, bbuf)
        # on the card, events around the carry update and the cycle: their
        # device-timeline spans, read once decisions() waited past them
        evs = ([torch.cuda.Event(enable_timing=True) for _ in range(3)]
               if wbuf.device.type == "cuda" else None)
        if evs:
            evs[0].record()
        if self._keeper is not None:
            carry = self._keeper.state(wbuf, bbuf, stable, dirty, carry_key)
            if evs:
                evs[1].record()
            result = self._cycle_fn(wbuf, bbuf, stable, carry, emask, escore)
        else:
            if evs:
                evs[1].record()
            result = self._cycle_fn(wbuf, bbuf, stable)
        if self._slim_fn is None:
            self._slim_fn = build_decision_slim_fn(result.node_requested.shape[0])
        a, flags = self._slim_fn(
            result.assignment, result.unschedulable, result.gang_dropped)
        if evs:
            evs[2].record()
        slim = self._fetch_slim(a, flags)
        handle = CycleHandle(self, result, slim, wbuf, bbuf, stable, emask)
        handle._events = evs
        self._slots[slot] = handle
        self._last = handle
        self._n += 1
        t1 = self._now()
        dispatch_s = t1 - t0
        self.stats = {
            "dispatch_ms": dispatch_s * 1e3,
            "slot": slot,
            "t_dispatch_start": t0,
            "t_dispatch_end": t1,
        }
        if self._pending_encode_ms is not None:
            self.stats["encode_ms"] = self._pending_encode_ms
            self._pending_encode_ms = None
        if self._metrics is not None:
            self._metrics.cycle_duration.labels(phase="dispatch").observe(dispatch_s)
        self._note_inflight()
        if self.forced_sync:
            handle.block()
            # sequential execution hides nothing
            self.stats["encode_hidden_ms"] = 0.0
        return handle

    def _speculation_outcome(self, outcome: str) -> None:
        self.speculation[outcome] += 1
        counter = getattr(self._metrics, "speculation", None) if self._metrics else None
        if counter is not None:
            counter.labels(outcome=outcome).inc()

    def adopt_speculative(self) -> MultiCycleHandle:
        """The predecessor's host fold matched the speculation's predicate:
        the speculative batch becomes the current one."""
        h = self._spec
        if h is None:
            raise RuntimeError("adopt_speculative: no speculation in flight")
        self._spec = None
        self._last = h
        self.stats = dict(h._stats_seed)
        self._speculation_outcome("adopted")
        return h

    def abandon_speculative(self) -> None:
        """Drop the in-flight speculative batch (its results are never
        observed) and free its slot. A no-op with none in flight, so
        failure paths may call it unconditionally."""
        h = self._spec
        if h is None:
            return
        self._spec = None
        h.fetched = True
        h.release()
        for i, s in enumerate(self._slots):
            if s is h:
                self._slots[i] = None
        self._speculation_outcome("abandoned")
        self._note_inflight()

    def note_redispatch(self) -> None:
        """Ledger mark: an abandoned speculation's groups re-dispatched."""
        self._speculation_outcome("redispatched")

    def _fetch_rows(self, rows):
        """Per-row slim copies into pinned host memory, each with its event
        (the card); on the CPU the tensors themselves."""
        return [self._fetch_slim(a, f) for a, f in rows]

    def dispatch_multi(
        self,
        wbufs,
        bbufs,
        stable,
        n_cycles: int,
        *,
        device_put: bool = True,
        carry0=None,
        speculative: bool = False,
        counts=None,
    ) -> MultiCycleHandle:
        """Upload + dispatch one multi-cycle batch (stacked [K, ...] frames,
        up to `n_cycles` inner cycles; reference `core/pipeline.py:1002`).
        Shares the single-dispatch ordering guard. `speculative=True` is the
        depth-2 relaxation: dispatched while its predecessor is unfetched,
        held aside until `adopt_speculative()` / `abandon_speculative()`.
        `carry0 = (carry_node_requested, carry_gplaced)` chains the
        predecessor's device-resident carry through `multi_cont_fn`.
        `counts` are the rows' valid-pod counts (the drain exit)."""
        fn = self.multi_fn
        if carry0 is not None:
            fn = self.multi_cont_fn
            if fn is None:
                raise RuntimeError(
                    "ServingPipeline.dispatch_multi: carry0 given but no "
                    "continuation program (pipe.multi_cont_fn)")
        if fn is None:
            raise RuntimeError(
                "ServingPipeline.dispatch_multi: no multi-cycle program "
                "(pipe.multi_fn = build_packed_multicycle_fn(...))")
        if self._spec is not None:
            raise RuntimeError(
                "ServingPipeline: dispatch_multi with an unresolved "
                "speculative batch in flight")
        if (not speculative and self.require_decision_fetch
                and self._last is not None and not self._last.fetched):
            raise RuntimeError(
                "ServingPipeline: multi-cycle batch dispatched before the "
                "previous cycle's decisions were fetched (speculative=True "
                "is the sanctioned depth-2 path)")
        t0 = self._now()
        slot = self._claim_slot()
        if device_put:
            wbufs, bbufs = self._upload(slot, wbufs, bbufs)
        else:
            wbufs, bbufs = _cpu_safe_buffers(wbufs, bbufs)
        if carry0 is not None:
            result = fn(wbufs, bbufs, stable, int(n_cycles), *carry0, counts=counts)
        else:
            result = fn(wbufs, bbufs, stable, int(n_cycles), counts=counts)
        if self._multi_slim_fn is None:
            self._multi_slim_fn = build_multicycle_slim_rows_fn(
                result.node_requested.shape[1])
        live = min(int(n_cycles), result.assignment.shape[0])
        slim = self._fetch_rows(self._multi_slim_fn(
            result.assignment, result.unschedulable, result.gang_dropped,
            result.attempted, live))
        handle = MultiCycleHandle(self, result, slim, wbufs, bbufs, stable,
                                  n_live=live, speculative=speculative)
        self._slots[slot] = handle
        if speculative:
            self._spec = handle
        else:
            self._last = handle
        self._n += 1
        t1 = self._now()
        stats = {"dispatch_ms": (t1 - t0) * 1e3, "slot": slot, "multi_cycles": int(n_cycles),
                 "t_dispatch_start": t0, "t_dispatch_end": t1}
        if self._pending_encode_ms is not None:
            stats["encode_ms"] = self._pending_encode_ms
            self._pending_encode_ms = None
        if speculative:
            # the in-flight batch keeps its stage report; adoption installs
            # this one
            handle._stats_seed = stats
            self.stats["spec_dispatch_ms"] = stats["dispatch_ms"]
        else:
            self.stats = stats
        if self._metrics is not None:
            self._metrics.cycle_duration.labels(phase="dispatch").observe(t1 - t0)
        self._note_inflight()
        if self.forced_sync and not speculative:
            handle.block()
            self.stats["encode_hidden_ms"] = 0.0
        return handle

    def inflight(self) -> int:
        """Dispatched cycles whose decisions were not fetched yet."""
        return sum(1 for h in self._slots if h is not None and not h.fetched)

    def _note_inflight(self) -> None:
        g = getattr(self._metrics, "cycle_inflight", None)
        if g is not None:
            g.set(self.inflight())

    def stage_report(self) -> dict[str, float]:
        """Last-cycle per-stage breakdown: dispatch_ms, decision_wait_ms,
        fetch_bytes (+ the full-payload bytes it replaced), diag_lag_ms,
        encode_ms, and encode_hidden_ms = max(0, encode - decision_wait)
        (0 under forced_sync)."""
        st = dict(self.stats)
        if "encode_hidden_ms" not in st:
            enc = st.get("encode_ms", 0.0)
            wait = st.get("decision_wait_ms", 0.0)
            st["encode_hidden_ms"] = max(0.0, enc - wait)
        return st
