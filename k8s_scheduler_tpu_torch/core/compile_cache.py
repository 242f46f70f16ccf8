"""The persistent kernel cache and the speculative warm builds (the port of
`k8s_scheduler_tpu/core/compile_cache.py`).

- **`CompileCache`** — an on-disk store under `compileCacheDir` (or
  `<stateDir>/compile_cache`). What the port stores is kernels, not XLA
  executables: one entry is one nvcc library, the shared object
  `ops/kernel_build.py build_cuda_library` writes. The entry framing is
  the reference's byte for byte: magic `KSCC`, version, a meta JSON, the
  payload, a CRC32 over meta and payload; writes go tmp file, fsync,
  rename, so concurrent same-key writers each land one whole entry (the
  last rename wins). A truncated, bit-flipped, other-version or
  other-fingerprint entry is REFUSED LOUDLY and counts as a miss: nvcc
  builds the library again, and the fresh build overwrites the bad entry.
  An `ENOSPC` on store refuses the store, never crashes, and the built
  library stays loaded. The `cache_torn` and `cache_enospc` fault points
  fire at the store, as in the reference.

- **Cache keys** — the library's name plus everything that makes two
  builds differ: the hash of the source and the headers it includes, the
  nvcc flags, and the fingerprint (nvcc, torch and CUDA versions and the
  card's `sm` capability) in the place of the reference's
  jax/jaxlib/backend one. `KEY_FIELDS` is the inventory, in key order.

- **`CompileWarmer`** — a lazy daemon thread the `Scheduler` feeds
  speculative builds (never the bind path): the adjacent pad regime's
  program closures and their first-use kernel builds.

Triton keys its own cache (`utils/compilation_cache.py` points
TRITON_CACHE_DIR inside the same tree), so its entries are not
KSCC-framed. The reference's `load_or_compile`, `_compile_natively` and
`_avals_digest` serve AOT-compiled XLA programs: the port has no
counterpart for them, since it compiles no program, only the kernels.
"""

# schedlint: disable-file=ID006 -- the reference's SIG_KEY_FIELDS pin its
# cache key to packing.SIGNATURE_DIMS because an XLA executable is built
# for one pad regime; a port entry is an nvcc library, which takes its
# shapes at launch and is the same for every regime, so KEY_FIELDS has no
# pad dimension and there is nothing to alias

from __future__ import annotations

import collections
import hashlib
import json
import logging
import os
import queue as _queue
import struct
import threading
import time as _time
import zlib
from typing import Callable

from . import faults as _faults

log = logging.getLogger("k8s_scheduler_tpu_torch.compile_cache")

_MAGIC = b"KSCC"
_VERSION = 1

# The key inventory, in key order (see the schedlint note above for why
# no pad dimension is among them).
KEY_FIELDS = ("library", "source", "flags", "fingerprint")

_NVCC_VERSION: "str | None" = None


def nvcc_version() -> str:
    """`nvcc --version`'s build tag (e.g. "V12.4.131"), "none" where nvcc
    is absent; asked once a process."""
    global _NVCC_VERSION
    if _NVCC_VERSION is None:
        import subprocess

        from ..ops.kernel_build import nvcc_path

        try:
            out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                                 text=True, timeout=30.0).stdout
            tags = [t.rstrip(",") for t in out.split() if t.startswith("V")]
            _NVCC_VERSION = tags[-1] if tags else "unknown"
        except (OSError, RuntimeError, ValueError) as e:
            log.info("compile cache: no nvcc version (%s)", e)
            _NVCC_VERSION = "none"
    return _NVCC_VERSION


def sm_capability() -> str:
    """Card 0's `sm` capability ("sm90"), "cpu" without a card: the
    fingerprint still names the toolchain, and a build that follows raises
    its own (louder) error."""
    import torch

    try:
        major, minor = torch.cuda.get_device_capability(0)
        return f"sm{major}{minor}"
    except (RuntimeError, AssertionError, AttributeError) as e:
        log.info("compile cache: no card capability (%s)", e)
        return "cpu"


def backend_fingerprint() -> str:
    """The toolchain and card a library is only valid under: nvcc, torch
    and CUDA versions and the `sm` capability of card 0. A mismatch is a
    MISS (the key embeds this), never a crash — an nvcc upgrade or another
    card builds from scratch."""
    import torch

    return (f"nvcc{nvcc_version()}-torch{torch.__version__}-"
            f"cuda{torch.version.cuda or 'none'}-{sm_capability()}")


class CacheKey:
    """One library's cache identity: the human-readable key string (stored
    inside the entry and verified on load) plus the filename stem (kind +
    a hash of the full key)."""

    __slots__ = ("text", "name")

    def __init__(self, text: str, kind: str) -> None:
        self.text = text
        digest = hashlib.sha256(text.encode()).hexdigest()[:24]
        self.name = f"{kind}-{digest}.kscc"

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"CacheKey({self.name}: {self.text})"


def cache_key(library: str, source_digest: str, flags, fingerprint: str) -> CacheKey:
    """The key of one nvcc library: iterates KEY_FIELDS so the key string
    and the documented inventory cannot diverge."""
    vals = {
        "library": library,
        "source": source_digest,
        "flags": hashlib.sha256(repr(tuple(flags)).encode()).hexdigest()[:16],
        "fingerprint": fingerprint,
    }
    return CacheKey("|".join(f"{f}={vals[f]}" for f in KEY_FIELDS), library)


class CompileCache:
    """The on-disk library store. Thread-safe: `load` / `store` may be
    called at once from the parallel builds and the warm thread (writes
    are tmp + fsync + rename; the last same-key writer wins whole)."""

    def __init__(self, directory: str, metrics=None,
                 fingerprint: "str | None" = None) -> None:
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._metrics = metrics
        self._fingerprint = fingerprint or backend_fingerprint()
        # in-memory tallies (the smoke run and /debug read these; the
        # metric families mirror them when metrics is wired); load_seconds
        # is a bounded window
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.load_seconds: "collections.deque[float]" = collections.deque(maxlen=256)

    # ---- entry framing ---------------------------------------------------

    def _path(self, key: CacheKey) -> str:
        return os.path.join(self.dir, key.name)

    def load(self, key: CacheKey) -> bytes | None:
        """The validated payload for `key`, or None (miss). Any framing
        violation — truncation, bit flips, a future format version, a
        key / fingerprint mismatch — logs loudly and reports a miss; the
        caller rebuilds and overwrites the bad entry."""
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            return None
        except OSError as e:
            log.error("compile cache: cannot read %s: %s", path, e)
            return None
        head = len(_MAGIC) + 8
        if len(blob) < head + 4 or blob[: len(_MAGIC)] != _MAGIC:
            log.error(
                "compile cache: REFUSING %s: bad magic/truncated header "
                "(%d bytes) — rebuilding", key.name, len(blob))
            return None
        version, meta_len = struct.unpack_from("<II", blob, len(_MAGIC))
        if version != _VERSION:
            log.error(
                "compile cache: REFUSING %s: format version %d (this "
                "build writes %d) — rebuilding", key.name, version, _VERSION)
            return None
        body = blob[head:-4]
        (crc,) = struct.unpack_from("<I", blob, len(blob) - 4)
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            log.error(
                "compile cache: REFUSING %s: CRC mismatch (truncated or "
                "bit-flipped entry) — rebuilding", key.name)
            return None
        if meta_len > len(body):
            log.error(
                "compile cache: REFUSING %s: meta length %d exceeds "
                "body — rebuilding", key.name, meta_len)
            return None
        try:
            meta = json.loads(body[:meta_len].decode())
        except ValueError:
            log.error("compile cache: REFUSING %s: unparseable meta — "
                      "rebuilding", key.name)
            return None
        if meta.get("key") != key.text:
            log.error(
                "compile cache: REFUSING %s: key mismatch (hash "
                "collision or stale rename) — rebuilding", key.name)
            return None
        if meta.get("fingerprint") != self._fingerprint:
            # the fingerprint is part of the key (and so of the filename):
            # a miss, not corruption
            log.warning(
                "compile cache: %s was built under %r, this process is "
                "%r — miss", key.name, meta.get("fingerprint"), self._fingerprint)
            return None
        return body[meta_len:]

    def store(self, key: CacheKey, payload: bytes, build_seconds: float = 0.0) -> bool:
        """Atomically write one entry: tmp file (unique per writer) +
        fsync + rename — a torn write can never be observed, and
        concurrent same-key writers each land a whole entry."""
        meta = json.dumps({
            "key": key.text,
            "fingerprint": self._fingerprint,
            "build_seconds": round(build_seconds, 3),
            "built_wall": _time.time(),
            "payload_bytes": len(payload),
        }).encode()
        body = meta + payload
        blob = (_MAGIC + struct.pack("<II", _VERSION, len(meta)) + body
                + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF))
        tmp = os.path.join(
            self.dir, f".{key.name}.tmp.{os.getpid()}.{threading.get_ident()}")
        try:
            if _faults.ARMED:
                # `cache_enospc` raises here (caught by the OSError handler
                # below: a refused store, never a crash); `cache_torn` lands
                # a TRUNCATED entry at the FINAL path, as if a rename
                # survived a crash its data did not — load() must refuse it
                _faults.raise_enospc("cache_enospc")
                if _faults.torn_store():
                    with open(self._path(key), "wb") as f:
                        f.write(blob[: max(len(blob) // 2, 1)])
                    log.error("compile cache: fault-injected torn write of %s", key.name)
                    return False
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(key))
            return True
        except OSError as e:
            log.error("compile cache: cannot store %s: %s", key.name, e)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False

    # ---- bookkeeping -----------------------------------------------------

    def note_hit(self, seconds: float) -> None:
        with self._lock:
            self.hits += 1
            self.load_seconds.append(seconds)
        m = self._metrics
        if m is not None:
            m.compile_cache_hits.inc()
            m.compile_cache_loads.observe(seconds)

    def note_miss(self) -> None:
        with self._lock:
            self.misses += 1
        m = self._metrics
        if m is not None:
            m.compile_cache_misses.inc()

    def entry_bytes(self) -> int:
        """Bytes of the entries on disk."""
        if not os.path.isdir(self.dir):
            return 0
        return sum(os.path.getsize(os.path.join(self.dir, n))
                   for n in os.listdir(self.dir) if n.endswith(".kscc"))

    def status(self) -> dict:
        """The /debug/state enrichment and the smoke run's fields."""
        with self._lock:
            loads = sorted(self.load_seconds)
            hits, misses = self.hits, self.misses
        return {
            "dir": self.dir,
            "fingerprint": self._fingerprint,
            "hits": hits,
            "misses": misses,
            "entries": sum(
                1 for n in os.listdir(self.dir) if n.endswith(".kscc")
            ) if os.path.isdir(self.dir) else 0,
            "serialize_unsupported": False,  # the reference's key: a library always stores
            "load_p50_s": round(loads[len(loads) // 2], 4) if loads else 0.0,
            "load_max_s": round(loads[-1], 4) if loads else 0.0,
        }


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
