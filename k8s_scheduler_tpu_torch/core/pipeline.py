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

`MultiCycleHandle`, `dispatch_multi` and depth-2 speculation are ROADMAP
A11: `dispatch_multi` raises."""

from __future__ import annotations

import threading as _threading
import time as _time

import numpy as np
import torch

from ..utils.device import resolve_device


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
            except BaseException as e:  # delivered whole to the serve thread
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
        """Run the one blocking wait of the decision path, under the
        watchdog when `dispatch_deadline_s` > 0."""
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
        except Exception:
            # the original error re-raises right after this call
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
        if st is None or st[0].numel() != wbuf.numel() or st[1].numel() != bbuf.numel():
            st = (torch.empty(wbuf.numel(), dtype=torch.int32, pin_memory=True),
                  torch.empty(bbuf.numel(), dtype=torch.uint8, pin_memory=True))
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

    def dispatch_multi(self, *a, **k):
        raise NotImplementedError(
            "multi-cycle dispatch is not ported yet (ROADMAP A11)")

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
