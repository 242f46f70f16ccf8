"""Leader election for active/standby HA (`k8s_scheduler_tpu/cmd/
leaderelection.py`): a lease file on shared storage. fcntl byte-range
locks give the atomic acquire; a heartbeat written under the lock gives
standbys and operators the holder and its age. The scheduler stays
stateless either way: a standby that takes over rebuilds its state from
the informers' re-list, so correctness never depends on the lease."""

from __future__ import annotations

import fcntl
import json
import logging
import os
import threading
import time as _time
from typing import Callable

log = logging.getLogger("k8s_scheduler_tpu_torch.cmd")


class FileLease:
    """Lock-file lease with heartbeat renewal.

    `acquire()` blocks until leadership is won (or `timeout` elapses). The
    holder renews by rewriting the heartbeat every `renew_seconds`; a
    holder that stops (crash, hang) loses the lock when its process dies,
    letting a standby in at once: the heartbeat is advisory metadata, the
    kernel lock is the truth."""

    # POSIX record locks are per process (two locks in one process never
    # conflict) and are dropped when the process closes ANY descriptor of
    # the file. This registry gives them flock-like semantics inside a
    # process: try_acquire of a held path fails, and holder() reads through
    # the holder's own descriptor.
    _held_lock = threading.Lock()
    _held: dict[str, "FileLease"] = {}

    def __init__(self, path: str, identity: str = "", renew_seconds: float = 2.0) -> None:
        self.path = path
        self.identity = identity or f"pid-{os.getpid()}"
        self.renew_seconds = renew_seconds
        self._fd: int | None = None
        self._stop = threading.Event()
        self._renewer: threading.Thread | None = None

    def _key(self) -> str:
        return os.path.realpath(self.path)

    # ---- acquisition ------------------------------------------------------

    def try_acquire(self) -> bool:
        with FileLease._held_lock:
            if self._key() in FileLease._held:
                return False
            fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
            try:
                # a POSIX byte-range lock (not flock): shared filesystems
                # propagate these, so the election holds across hosts
                fcntl.lockf(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                os.close(fd)
                return False
            self._fd = fd
            FileLease._held[self._key()] = self
        self._write_heartbeat()
        return True

    def acquire(self, timeout: float | None = None, poll_seconds: float = 0.5) -> bool:
        deadline = None if timeout is None else _time.monotonic() + timeout
        while True:
            if self.try_acquire():
                return True
            if deadline is not None and _time.monotonic() >= deadline:
                return False
            _time.sleep(poll_seconds)

    def start_renewing(self) -> None:
        self._renewer = threading.Thread(target=self._renew_loop, name="lease-renewer",
                                         daemon=True)
        self._renewer.start()

    def _renew_loop(self) -> None:
        while not self._stop.wait(self.renew_seconds):
            self._write_heartbeat()

    def _write_heartbeat(self) -> None:
        if self._fd is None:
            return
        payload = json.dumps({
            "holderIdentity": self.identity,
            "renewTime": _time.time(),
            "leaseDurationSeconds": self.renew_seconds * 3,
        }).encode()
        os.lseek(self._fd, 0, os.SEEK_SET)
        os.truncate(self._fd, 0)
        os.write(self._fd, payload)

    # ---- observation (standbys, operators) --------------------------------

    def holder(self) -> dict | None:
        """The advisory heartbeat (None without a lease file or content)."""
        try:
            with FileLease._held_lock:
                held = FileLease._held.get(self._key())
                if held is not None and held._fd is not None:
                    # this process holds the lock: read through the
                    # holder's descriptor (closing another one for the file
                    # would drop the lock)
                    data = os.pread(self._fd or held._fd, 65536, 0)
                    return json.loads(data) if data else None
            with open(self.path, "rb") as f:
                data = f.read()
            return json.loads(data) if data else None
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def is_leader(self) -> bool:
        return self._fd is not None

    def lease_age_seconds(self) -> float:
        """Seconds since the heartbeat was last renewed (0.0 without one):
        for a standby it grows past leaseDurationSeconds when the active
        stops renewing (the scheduler_leader_lease_age_seconds gauge)."""
        info = self.holder()
        if not info or "renewTime" not in info:
            return 0.0
        return max(0.0, _time.time() - float(info["renewTime"]))

    def describe(self) -> dict:
        """The lease's identity and age, for /healthz and dashboards."""
        info = self.holder() or {}
        return {
            "leader": self.is_leader(),
            "holder": info.get("holderIdentity", ""),
            "age_s": round(self.lease_age_seconds(), 3),
            "lease_duration_s": info.get("leaseDurationSeconds"),
            "path": self.path,
        }

    def release(self) -> None:
        self._stop.set()
        if self._renewer is not None:
            # the renewer wakes from its stop-event wait at once; 5 s pass
            # only when a heartbeat write hangs on dead shared storage
            self._renewer.join(timeout=5)
            if self._renewer.is_alive():
                log.warning("lease renewer failed to exit within 5s of release() "
                            "(heartbeat write wedged?); the lock below is still released")
            self._renewer = None
        with FileLease._held_lock:
            if self._fd is not None:
                fcntl.lockf(self._fd, fcntl.LOCK_UN)
                os.close(self._fd)
                self._fd = None
                if FileLease._held.get(self._key()) is self:
                    del FileLease._held[self._key()]


def run_with_leader_election(
    lease: FileLease,
    run: Callable[[], None],
    on_started_leading: Callable[[], None] | None = None,
) -> None:
    """Block until leadership, then run (upstream leaderElection.Run)."""
    lease.acquire()
    lease.start_renewing()
    if on_started_leading is not None:
        on_started_leading()
    try:
        run()
    finally:
        lease.release()
