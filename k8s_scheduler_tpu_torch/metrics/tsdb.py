"""In-process metrics time-series store (the watchtower's memory; the
port's copy of `k8s_scheduler_tpu/metrics/tsdb.py`: the same rings,
tiers, queries and arming).

Every `scheduler_*` family is scrape-time-only: `set_function` gauges
evaluate at `/metrics` GET and their history evaporates with the
response. Post-mortems need "what was burn rate doing in the 60 s
before the ladder dropped" WITHOUT an external Prometheus having
scraped at the right moment, so this module keeps a bounded history
inside the process, on the flight-recorder discipline: bounded rings,
seqlock-style publication, writers never block the serve loop.

Two samplers feed the store:

- `MetricsTSDB.observe_record` rides the existing
  `FlightRecorder.observers` publish hook: each committed cycle record
  contributes its phase durations (`cycle_phase_ms{phase}`)
  and integer counts (`cycle_count{key}`) at cycle rate.
- a low-frequency wall ticker (`start_ticker`) walks the metrics
  registry's `collect()` (metrics/metrics.py `Registry.collect`) — which
  is exactly a scrape, so `set_function` gauges evaluate — and appends
  every family/labelset sample (histogram `_bucket`/`_created` series
  excluded to bound fan-out).

Storage is one `_Series` per (family, labelset): a raw ring of
`(t, value)` pairs plus tiered downsampling into 1 s and 1 m aggregate
buckets carrying `(bucket_t, min, max, sum, count, last)`. Append is
O(1) (ring slot store + two in-place bucket folds); memory is bounded
by `cap` knobs and a hard series-count ceiling, so a months-lived
daemon holds hours of 1 m history in a few MB.

Concurrency: two writer threads exist (the scheduling loop via the
observer hook, the wall ticker) and take a small lock ONLY against each
other — readers never take it. Slots and open buckets are immutable
tuples replaced wholesale, publication is a per-series monotonically
increasing `commits` counter, and readers retry their window copy until
no commit tore it (`core/flight_recorder.py` seqlock discipline).

Arming follows `core/spans.py`: module-level `ARMED` flag +
`arm()`/`disarm()`; unarmed, the observer hook is one global load and a
branch, and nothing else runs. The store is stdlib-only (no torch or
numpy) so tools and tests can import it without a device.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable

log = logging.getLogger(__name__)

# Module arming (core/spans.py discipline). `ARMED` gates the hot
# observer hook; `STORE` is the armed singleton `arm_watchtower` wires
# into the debug endpoints and the black box.
ARMED = False
STORE: "MetricsTSDB | None" = None

# Default ring capacities: ~17 min of raw cycle samples at 2 s ticks,
# 10 min of 1 s buckets, 12 h of 1 m buckets. All per-series.
DEFAULT_RAW_CAP = 512
DEFAULT_SEC_CAP = 600
DEFAULT_MIN_CAP = 720

# Hard ceiling on distinct (family, labelset) series: a label-cardinality
# explosion degrades to dropped series + a counted complaint, never to
# unbounded memory.
MAX_SERIES = 4096

# Registry sample suffixes that would multiply series count without
# adding history value (bucketed histograms are reconstructible enough
# from _sum/_count for rule evaluation).
_SKIP_SUFFIXES = ("_bucket", "_created", "_gsum", "_gcount")


def _labels_key(labels: Any) -> tuple:
    """Normalizes a labels mapping to a hashable sorted tuple."""
    if not labels:
        return ()
    if isinstance(labels, tuple):
        return labels
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Series:
    """One (family, labelset) history: raw ring + 1 s / 1 m buckets.

    Writer side is externally serialized (MetricsTSDB._write_lock);
    readers are lock-free against the `commits` seqlock. Every slot is
    an immutable tuple so a torn read can only misorder the window,
    never expose a half-written point — the seqlock retry handles the
    ordering."""

    __slots__ = (
        "family", "labels", "commits", "total",
        "raw", "raw_n", "raw_cap",
        "sec", "sec_n", "sec_cap", "open_sec",
        "minute", "min_n", "min_cap", "open_min",
    )

    def __init__(self, family: str, labels: tuple,
                 raw_cap: int, sec_cap: int, min_cap: int):
        self.family = family
        self.labels = labels
        self.commits = 0
        self.total = 0
        self.raw: list = [None] * raw_cap
        self.raw_n = 0
        self.raw_cap = raw_cap
        self.sec: list = [None] * sec_cap
        self.sec_n = 0
        self.sec_cap = sec_cap
        self.open_sec: tuple | None = None
        self.minute: list = [None] * min_cap
        self.min_n = 0
        self.min_cap = min_cap
        self.open_min: tuple | None = None

    # -- writer side (serialized by MetricsTSDB._write_lock) ----------

    def append(self, t: float, v: float) -> None:
        self.raw[self.raw_n % self.raw_cap] = (t, v)
        self.raw_n += 1
        self.total += 1
        self.open_sec, flushed = self._fold(self.open_sec, float(int(t)), t, v)
        if flushed is not None:
            self.sec[self.sec_n % self.sec_cap] = flushed
            self.sec_n += 1
        self.open_min, flushed = self._fold(
            self.open_min, float(int(t // 60) * 60), t, v)
        if flushed is not None:
            self.minute[self.min_n % self.min_cap] = flushed
            self.min_n += 1
        # publish: single int store; CPython readers see it atomically
        self.commits += 1

    @staticmethod
    def _fold(bucket: tuple | None, bt: float, t: float, v: float):
        """Folds (t, v) into an aggregate bucket keyed by start time
        `bt`; returns (new_open_bucket, flushed_bucket_or_None)."""
        if bucket is None or bucket[0] != bt:
            return (bt, v, v, v, 1, v), bucket
        _, mn, mx, sm, cnt, _ = bucket
        return (bt, min(mn, v), max(mx, v), sm + v, cnt + 1, v), None

    # -- reader side (lock-free) --------------------------------------

    def _copy_ring(self, ring: list, n: int, cap: int, last: int) -> list:
        avail = min(n, cap)
        take = avail if last <= 0 else min(last, avail)
        start = n - take
        return [ring[i % cap] for i in range(start, n)]

    def snapshot(self, raw_last: int = 0, sec_last: int = 0,
                 min_last: int = 0) -> dict:
        """Seqlock-consistent copy of all three tiers (+ open buckets).
        `*_last` bound how much of each ring is copied (0 = all)."""
        out = None
        for _ in range(16):
            c0 = self.commits
            out = {
                "family": self.family,
                "labels": dict(self.labels),
                "total": self.total,
                "raw": self._copy_ring(
                    self.raw, self.raw_n, self.raw_cap, raw_last),
                "sec": self._copy_ring(
                    self.sec, self.sec_n, self.sec_cap, sec_last),
                "minute": self._copy_ring(
                    self.minute, self.min_n, self.min_cap, min_last),
                "open_sec": self.open_sec,
                "open_minute": self.open_min,
            }
            if self.commits == c0:
                return out
        # 16 consecutive torn windows means the writer is outrunning
        # us; the last copy is still made of immutable tuples (worst
        # case: one ring slightly newer than another). Bounded
        # staleness beats blocking the reader forever.
        return out


class MetricsTSDB:
    """Bounded in-process TSDB over scheduler metric families.

    See module docstring for the storage/concurrency model. The armed
    instance also drives the alert `RuleEngine` (metrics/rules.py) when
    one is attached via `self.engine`: evaluation is throttled to
    `eval_interval_s` and runs from whichever sampler fires next, so
    rules keep evaluating off the wall ticker even when the scheduling
    loop is wedged — exactly the case alerts exist for."""

    def __init__(self, raw_cap: int = DEFAULT_RAW_CAP,
                 sec_cap: int = DEFAULT_SEC_CAP,
                 min_cap: int = DEFAULT_MIN_CAP,
                 max_series: int = MAX_SERIES,
                 eval_interval_s: float = 1.0):
        self.raw_cap = max(16, int(raw_cap))
        self.sec_cap = max(16, int(sec_cap))
        self.min_cap = max(16, int(min_cap))
        self.max_series = max_series
        self.eval_interval_s = eval_interval_s
        self._series: dict[tuple[str, tuple], _Series] = {}
        self._write_lock = threading.Lock()
        self.dropped_series = 0
        self.engine = None  # metrics/rules.RuleEngine, attached by arm_watchtower
        self._last_eval = 0.0
        self._eval_lock = threading.Lock()
        self._ticker: threading.Thread | None = None
        self._ticker_stop = threading.Event()
        self.ticks = 0

    # ---- writer side -------------------------------------------------

    def append(self, family: str, labels: Any, value: float,
               t: float | None = None) -> None:
        """O(1) append of one sample; creates the series on first use."""
        key = (family, _labels_key(labels))
        t = time.time() if t is None else t
        with self._write_lock:
            s = self._series.get(key)
            if s is None:
                if len(self._series) >= self.max_series:
                    self.dropped_series += 1
                    return
                s = _Series(family, key[1],
                            self.raw_cap, self.sec_cap, self.min_cap)
                self._series[key] = s
            s.append(t, float(value))

    def observe_record(self, rec) -> None:
        """FlightRecorder observer hook: samples one committed cycle.

        First line is the whole unarmed cost (one global load + branch,
        core/spans.py ARMED discipline)."""
        if not ARMED:
            return
        try:
            t = rec.wall_start
            for phase, ms in rec.phases.items():
                self.append("cycle_phase_ms",
                            (("phase", phase),), ms, t=t)
            for k, v in rec.counts.items():
                self.append("cycle_count",
                            (("key", str(k)),), v, t=t)
        except Exception:
            # schedlint: disable=RB001 -- sampler must never take down
            # the scheduling loop; FlightRecorder detaches a raising
            # observer, so swallow + log here keeps us attached.
            log.exception("tsdb: cycle sample failed")
        self.maybe_evaluate()

    def sample_registry(self, registry) -> None:
        """Walks a registry's collect() — i.e. one scrape, so
        `set_function` gauges evaluate — and appends every sample
        (histogram bucket fan-out excluded)."""
        t = time.time()
        try:
            families = list(registry.collect())
        except Exception:
            # schedlint: disable=RB001 -- a raising set_function gauge
            # (e.g. during shutdown teardown) must not kill the ticker.
            log.exception("tsdb: registry collect failed")
            return
        for fam in families:
            for sample in fam.samples:
                name = sample.name
                if name.endswith(_SKIP_SUFFIXES):
                    continue
                self.append(name, sample.labels, sample.value, t=t)

    # ---- rule-engine drive -------------------------------------------

    def maybe_evaluate(self, now: float | None = None) -> None:
        """Runs attached alert rules at most once per eval interval."""
        eng = self.engine
        if eng is None:
            return
        now = time.time() if now is None else now
        with self._eval_lock:
            if now - self._last_eval < self.eval_interval_s:
                return
            self._last_eval = now
            try:
                eng.evaluate(now)
            except Exception:
                # schedlint: disable=RB001 -- rule evaluation is
                # advisory; it must never block sampling or the loop.
                log.exception("tsdb: rule evaluation failed")

    # ---- wall ticker -------------------------------------------------

    def start_ticker(self, registry, interval_s: float = 2.0,
                     extra: Callable[[], None] | None = None) -> None:
        """Starts the low-frequency sampler thread for scrape-time
        gauges. Idempotent; `stop_ticker`/`disarm` joins it."""
        if self._ticker is not None or interval_s <= 0:
            return
        self._ticker_stop.clear()

        def _run():
            while not self._ticker_stop.wait(interval_s):
                self.sample_registry(registry)
                if extra is not None:
                    try:
                        extra()
                    except Exception:
                        # schedlint: disable=RB001 -- auxiliary sampler
                        # must not kill the ticker thread.
                        log.exception("tsdb: extra sampler failed")
                self.ticks += 1
                self.maybe_evaluate()

        self._ticker = threading.Thread(
            target=_run, name="metrics-tsdb-ticker", daemon=True)
        self._ticker.start()

    def stop_ticker(self) -> None:
        th = self._ticker
        if th is None:
            return
        self._ticker_stop.set()
        th.join(timeout=5.0)
        self._ticker = None

    # ---- reader side -------------------------------------------------

    def _match(self, family: str | None,
               labels: dict | None) -> list[_Series]:
        want = _labels_key(labels) if labels else ()
        out = []
        for (fam, lk), s in list(self._series.items()):
            if family and fam != family:
                continue
            if want and not set(want).issubset(set(lk)):
                continue
            out.append(s)
        return out

    def query(self, family: str, labels: dict | None = None,
              window_s: float = 300.0, step_s: float = 0.0,
              now: float | None = None) -> dict:
        """History query for `/debug/metrics/history` and the rules
        engine. Tier selection: step >= 60 -> 1 m buckets, step >= 1 ->
        1 s buckets, else raw points. Points within [now - window, now];
        aggregate tiers return [t, min, max, sum, count, last] rows,
        raw returns [t, value]."""
        now = time.time() if now is None else now
        lo = now - max(0.0, float(window_s))
        tier = "1m" if step_s >= 60 else ("1s" if step_s >= 1 else "raw")
        series_out = []
        for s in self._match(family, labels):
            snap = s.snapshot()
            if tier == "raw":
                pts = [[t, v] for (t, v) in snap["raw"] if t >= lo]
            else:
                ring = snap["sec"] if tier == "1s" else snap["minute"]
                open_b = (snap["open_sec"] if tier == "1s"
                          else snap["open_minute"])
                buckets = list(ring)
                if open_b is not None:
                    buckets.append(open_b)
                pts = [list(b) for b in buckets if b[0] >= lo]
            series_out.append({
                "labels": snap["labels"],
                "total_samples": snap["total"],
                "points": pts,
            })
        return {"family": family, "tier": tier, "now": now,
                "window_s": window_s, "series": series_out}

    def families(self) -> list[dict]:
        """Inventory of stored series for endpoint discovery."""
        rows: dict[str, dict] = {}
        for (fam, lk), s in sorted(self._series.items()):
            row = rows.setdefault(fam, {"family": fam, "series": 0,
                                        "samples": 0})
            row["series"] += 1
            row["samples"] += s.total
        return list(rows.values())

    def status(self) -> dict:
        return {
            "armed": ARMED,
            "series": len(self._series),
            "dropped_series": self.dropped_series,
            "ticks": self.ticks,
            "caps": {"raw": self.raw_cap, "sec": self.sec_cap,
                     "minute": self.min_cap},
        }

    def snapshot_all(self, raw_last: int = 128, sec_last: int = 120,
                     min_last: int = 120) -> dict:
        """Bounded full dump for the black box: every series' recent
        window across all tiers."""
        return {
            "status": self.status(),
            "series": [s.snapshot(raw_last=raw_last, sec_last=sec_last,
                                  min_last=min_last)
                       for s in self._match(None, None)],
        }


def arm(store: MetricsTSDB | None = None, **kwargs) -> MetricsTSDB:
    """Arms the module (and creates the store unless one is passed).
    Returns the armed store; callers attach `observe_record` to their
    FlightRecorder and optionally `start_ticker`."""
    global ARMED, STORE
    if store is None:
        store = STORE if STORE is not None else MetricsTSDB(**kwargs)
    STORE = store
    ARMED = True
    return store


def disarm() -> None:
    """Disarms sampling and stops the ticker thread. The store object
    stays valid for post-mortem reads (black box dumps at shutdown)."""
    global ARMED, STORE
    ARMED = False
    store, STORE = STORE, None
    if store is not None:
        store.stop_ticker()
