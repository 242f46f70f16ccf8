"""The speculative warm builds of `k8s_scheduler_tpu/core/compile_cache.py`:
`CompileWarmer` only, so that `speculativeCompile` (on by default) keeps
the `Scheduler`'s `_maybe_speculate` / `_warm_regime`.

The port has no XLA compile: a regime build is its program closures plus
the first-use nvcc builds, which `ops/kernel_build.py` caches per process.
The warm thread builds closures and kernels and launches nothing on the
serving stream. The persistent executable cache (`compileCacheDir`) is
ROADMAP A10b."""

from __future__ import annotations

import logging
import queue as _queue
import threading
import time as _time
from typing import Callable

log = logging.getLogger("k8s_scheduler_tpu_torch.compile_cache")


class CompileWarmer:
    """The speculative-precompilation thread: a queue of build thunks,
    drained by one lazy daemon thread so a build never runs on the
    scheduling loop. Jobs are deduplicated by key while queued or running.
    Failures are logged and swallowed — speculation is an optimization, a
    bad prediction costs nothing but the wasted build."""

    def __init__(self, metrics=None) -> None:
        self._metrics = metrics
        self._q: _queue.Queue = _queue.Queue()
        self._inflight: set = set()
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.built = 0
        self.failed = 0

    def enqueue_build(self, key, thunk: Callable[[], None]) -> bool:
        """Enqueue one speculative build; False when the same key is
        already queued or building."""
        with self._lock:
            if self._stop.is_set() or key in self._inflight:
                return False
            self._inflight.add(key)
            # the put rides inside the lock: the worker's drain-exit checks
            # queue emptiness under the same lock
            self._q.put((key, thunk))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="compile-warmer", daemon=True)
                self._thread.start()
        return True

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                key, thunk = self._q.get(timeout=5.0)
            except _queue.Empty:
                with self._lock:
                    if self._q.empty():
                        self._thread = None
                        return
                continue
            try:
                thunk()
                with self._lock:
                    self.built += 1
                m = self._metrics
                if m is not None:
                    m.compile_cache_speculative.inc()
            except Exception:
                with self._lock:
                    self.failed += 1
                log.exception(
                    "compile warmer: speculative build %r failed "
                    "(prediction discarded)", key)
            finally:
                with self._lock:
                    self._inflight.discard(key)
                self._q.task_done()

    def idle(self) -> bool:
        with self._lock:
            return not self._inflight

    def join(self, timeout: float = 30.0) -> bool:
        """Wait for the queue to drain."""
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            if self.idle():
                return True
            _time.sleep(0.02)
        return False

    def stop(self) -> None:
        self._stop.set()
