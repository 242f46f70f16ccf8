"""The port's persistent kernel cache (`core/compile_cache.py`,
`utils/compilation_cache.py`, `ops/kernel_build.py` through the cache)
against the reference's `core/compile_cache.py`.

- Entry bytes equal the reference `CompileCache.store`'s for the same key
  text, payload, fingerprint and a fixed clock; each package reads the
  other's entries and refuses the other's torn, bit-flipped, other-version
  and other-fingerprint entries.
- Concurrent same-key writers leave one whole entry and no temporary file.
- `cache_torn` and `cache_enospc` fire from a `faultSpec`: a torn entry
  lands at the final path and is refused, an ENOSPC refuses the store and
  crashes nothing.
- `kernel_build` through the cache, with a stand-in builder (g++ builds a
  real shared library, since this machine has no nvcc): a cold load runs
  the builder once and stores the entry; a second, process-like load (the
  process's libraries and build directory gone) runs it zero times and
  lands the stored bytes; a torn entry is rebuilt.
- A `Scheduler` with `compileCacheDir` is no longer refused, and derives
  `<stateDir>/compile_cache` as the reference's does.
Every comparison is exact."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import pytest

import k8s_scheduler_tpu.core.compile_cache as ref_cc
import k8s_scheduler_tpu_torch.core.compile_cache as port_cc
import k8s_scheduler_tpu_torch.core.faults as faults
import k8s_scheduler_tpu_torch.ops.kernel_build as kb
from k8s_scheduler_tpu_torch.config import SchedulerConfiguration
from k8s_scheduler_tpu_torch.core import Scheduler
from k8s_scheduler_tpu_torch.state import DurableState
from k8s_scheduler_tpu_torch.utils.compilation_cache import enable_compilation_cache
from torch_one_thread import one_torch_thread  # noqa: F401

FP = "nvccV12.4.131-torch2.5.1-cuda12.4-sm90"
KEY_TEXT = "library=capacity|source=0123456789abcdef|flags=fedcba9876543210|fingerprint=" + FP
PAYLOADS = {
    "empty": b"",
    "text": b"a small payload",
    "binary": bytes(range(256)) * 37,
    "elf_like": b"\x7fELF" + bytes(4093),
}


@pytest.fixture(autouse=True)
def _process_state(monkeypatch, tmp_path):
    """The kernel cache and build directory are process-wide: every test
    leaves them, the TRITON_CACHE_DIR variable and the fault plan as it
    found them."""
    monkeypatch.setattr(kb, "BUILD_DIR", kb.BUILD_DIR)
    monkeypatch.setattr(kb, "_CACHE", None)
    monkeypatch.setattr(kb, "_libs", {})
    monkeypatch.setattr(kb, "build_stats", {"nvcc": 0, "hits": 0, "misses": 0, "load_s": 0.0})
    monkeypatch.setenv("TRITON_CACHE_DIR", str(tmp_path / "triton-preset"))
    yield
    faults.disarm()


def _pair(tmp_path, monkeypatch, clock=1700000000.25):
    monkeypatch.setattr(ref_cc._time, "time", lambda: clock)
    monkeypatch.setattr(port_cc._time, "time", lambda: clock)
    ref = ref_cc.CompileCache(str(tmp_path / "ref"))
    ref._fingerprint = FP
    port = port_cc.CompileCache(str(tmp_path / "port"), fingerprint=FP)
    return ref, port


@pytest.mark.parametrize("payload", sorted(PAYLOADS))
def test_entry_bytes_equal_reference(tmp_path, monkeypatch, payload):
    ref, port = _pair(tmp_path, monkeypatch)
    rk, pk = ref_cc.CacheKey(KEY_TEXT, "capacity"), port_cc.CacheKey(KEY_TEXT, "capacity")
    assert rk.name == pk.name
    assert ref.store(rk, PAYLOADS[payload], build_seconds=12.34567)
    assert port.store(pk, PAYLOADS[payload], build_seconds=12.34567)
    a = (tmp_path / "ref" / rk.name).read_bytes()
    b = (tmp_path / "port" / pk.name).read_bytes()
    assert a == b
    # each package reads the other's entry
    assert port.load(pk) == ref.load(rk) == PAYLOADS[payload]
    os.replace(tmp_path / "ref" / rk.name, tmp_path / "port" / pk.name)
    assert port.load(pk) == PAYLOADS[payload]


def _torn(blob: bytes) -> bytes:
    return blob[: len(blob) // 2]


def _flip_payload(blob: bytes) -> bytes:
    b = bytearray(blob)
    b[-10] ^= 0x10
    return bytes(b)


def _flip_meta(blob: bytes) -> bytes:
    b = bytearray(blob)
    b[20] ^= 0x01
    return bytes(b)


def _version(blob: bytes) -> bytes:
    return blob[:4] + (2).to_bytes(4, "little") + blob[8:]


def _magic(blob: bytes) -> bytes:
    return b"XSCC" + blob[4:]


CORRUPTIONS = {"torn": _torn, "flip_payload": _flip_payload, "flip_meta": _flip_meta,
               "version": _version, "magic": _magic, "empty": lambda b: b""}


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("how", sorted(CORRUPTIONS))
def test_each_refuses_the_others_bad_entry(tmp_path, monkeypatch, writer, how):
    ref, port = _pair(tmp_path, monkeypatch)
    rk, pk = ref_cc.CacheKey(KEY_TEXT, "capacity"), port_cc.CacheKey(KEY_TEXT, "capacity")
    src = ref if writer == "ref" else port
    assert src.store(rk if writer == "ref" else pk, PAYLOADS["binary"])
    blob = (tmp_path / writer / rk.name).read_bytes()
    bad = CORRUPTIONS[how](blob)
    for d in ("ref", "port"):
        (tmp_path / d / rk.name).write_bytes(bad)
    assert ref.load(rk) is None
    assert port.load(pk) is None


def test_other_fingerprint_is_a_miss_in_both(tmp_path, monkeypatch):
    ref, port = _pair(tmp_path, monkeypatch)
    rk, pk = ref_cc.CacheKey(KEY_TEXT, "capacity"), port_cc.CacheKey(KEY_TEXT, "capacity")
    assert port.store(pk, PAYLOADS["text"])
    ref._fingerprint = port._fingerprint = "another-toolchain"
    os.replace(tmp_path / "port" / pk.name, tmp_path / "ref" / rk.name)
    assert ref.load(rk) is None
    (tmp_path / "port" / pk.name).write_bytes((tmp_path / "ref" / rk.name).read_bytes())
    assert port.load(pk) is None


def test_key_inventory_and_names():
    k1 = port_cc.cache_key("capacity", "abc", ("-O3",), FP)
    assert k1.text == "|".join(f"{f}={v}" for f, v in zip(
        port_cc.KEY_FIELDS, k1.text.replace("|", "=").split("=")[1::2]))
    assert [p.split("=")[0] for p in k1.text.split("|")] == list(port_cc.KEY_FIELDS)
    assert k1.name.startswith("capacity-") and k1.name.endswith(".kscc")
    # every field moves the key
    for args in (("static_base", "abc", ("-O3",), FP), ("capacity", "abd", ("-O3",), FP),
                 ("capacity", "abc", ("-O2",), FP), ("capacity", "abc", ("-O3",), "x")):
        assert port_cc.cache_key(*args).name != k1.name


def test_concurrent_same_key_writers_leave_one_whole_entry(tmp_path):
    port = port_cc.CompileCache(str(tmp_path), fingerprint=FP)
    key = port_cc.CacheKey(KEY_TEXT, "capacity")
    payloads = [bytes([i]) * (4096 + i) for i in range(8)]
    barrier = threading.Barrier(len(payloads))

    def write(p):
        barrier.wait()
        assert port.store(key, p)

    ts = [threading.Thread(target=write, args=(p,)) for p in payloads]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert port.load(key) in payloads
    assert sorted(os.listdir(tmp_path)) == [key.name]


@pytest.mark.parametrize("spec,stored", [("cache_torn@n=1", "torn"),
                                         ("cache_enospc@n=1", "none")])
def test_fault_points_fire_from_a_fault_spec(tmp_path, spec, stored):
    s = Scheduler(SchedulerConfiguration(compile_cache_dir=str(tmp_path / "cc"),
                                         fault_spec=spec), device="cpu")
    cache = s._compile_cache
    assert cache is not None and cache is kb._CACHE
    key = port_cc.CacheKey(KEY_TEXT, "capacity")
    assert cache.store(key, PAYLOADS["binary"]) is False  # refused, no crash
    path = tmp_path / "cc" / key.name
    if stored == "torn":
        assert path.exists() and 0 < path.stat().st_size < len(PAYLOADS["binary"])
        assert cache.load(key) is None  # refused loudly, a miss
    else:
        assert not path.exists()
    assert faults.plan().fired_points() == {spec.split("@")[0]}
    assert [n for n in os.listdir(tmp_path / "cc") if ".tmp." in n] == []
    # the point fired once (n=1): the next store lands whole
    assert cache.store(key, PAYLOADS["binary"]) is True
    assert cache.load(key) == PAYLOADS["binary"]


_STAND_IN_C = "int stand_in_answer(void) { return %d; }\n"


def _stand_in_builder(calls: list, answer: int = 42):
    """Builds a real shared library with g++ in place of nvcc's."""
    def run_nvcc(src, flags, out):
        calls.append((src.name, flags))
        c = out.with_suffix(".c")
        c.write_text(_STAND_IN_C % answer)
        subprocess.run(["g++", "-shared", "-fPIC", "-x", "c", str(c), "-o", str(out)],
                       check=True, capture_output=True)
        c.unlink()
        return "stand-in build"
    return run_nvcc


def _new_process(monkeypatch, cache_dir):
    """What a new process sees: no library loaded, no build directory (a
    cold child would otherwise find the last one's libraries), a fresh
    cache handle on the same store."""
    import shutil

    monkeypatch.setattr(kb, "_libs", {})
    monkeypatch.setattr(kb, "build_stats", {"nvcc": 0, "hits": 0, "misses": 0, "load_s": 0.0})
    cc = enable_compilation_cache(str(cache_dir))
    for d in os.listdir(cache_dir):
        if os.path.isdir(cache_dir / d):
            shutil.rmtree(cache_dir / d)
    return cc


def test_kernel_build_through_the_cache_builds_once(tmp_path, monkeypatch):
    calls: list = []
    monkeypatch.setattr(kb, "run_nvcc", _stand_in_builder(calls))
    cache_dir = tmp_path / "kscc"
    cc = _new_process(monkeypatch, cache_dir)
    assert kb.BUILD_DIR == cache_dir / "cpu"
    assert os.environ["TRITON_CACHE_DIR"] == str(tmp_path / "triton-preset")
    lib = kb.load_cuda_library("capacity")
    assert lib.stand_in_answer() == 42
    assert len(calls) == 1 and kb.build_stats["nvcc"] == 1
    assert (kb.build_stats["hits"], kb.build_stats["misses"]) == (0, 1)
    assert (cc.hits, cc.misses) == (0, 1)
    assert kb.load_cuda_library("capacity") is lib  # loaded once a process
    built = {p.name: p.read_bytes() for p in kb.BUILD_DIR.glob("*.so")}
    assert len(built) == 1
    entries = [n for n in os.listdir(cache_dir) if n.endswith(".kscc")]
    assert len(entries) == 1 and entries[0].startswith("capacity-")

    # a second, process-like load: zero builds, the stored bytes landed
    cc2 = _new_process(monkeypatch, cache_dir)
    lib2 = kb.load_cuda_library("capacity")
    assert lib2.stand_in_answer() == 42
    assert len(calls) == 1 and kb.build_stats["nvcc"] == 0
    assert (kb.build_stats["hits"], kb.build_stats["misses"]) == (1, 0)
    assert (cc2.hits, cc2.misses) == (1, 0)
    assert {p.name: p.read_bytes() for p in kb.BUILD_DIR.glob("*.so")} == built
    assert [n for n in os.listdir(kb.BUILD_DIR) if ".tmp" in n] == []

    # a torn entry: refused, built again, stored whole
    path = cache_dir / entries[0]
    path.write_bytes(path.read_bytes()[:100])
    _new_process(monkeypatch, cache_dir)
    assert kb.load_cuda_library("capacity").stand_in_answer() == 42
    assert len(calls) == 2
    assert (kb.build_stats["nvcc"], kb.build_stats["hits"], kb.build_stats["misses"]) == (1, 0, 1)
    _new_process(monkeypatch, cache_dir)
    kb.load_cuda_library("capacity")
    assert len(calls) == 2 and kb.build_stats["hits"] == 1


def test_kernel_build_keys_source_and_flags(tmp_path, monkeypatch):
    """Two libraries, and a harness instance of one source, are three
    entries; a library's entry does not serve another."""
    calls: list = []
    monkeypatch.setattr(kb, "run_nvcc", _stand_in_builder(calls))
    cache_dir = tmp_path / "kscc"
    _new_process(monkeypatch, cache_dir)
    for name in ("capacity", "scan_commit", "scan_commit_tie_last"):
        kb.load_cuda_library(name)
    assert [c[0] for c in calls] == ["capacity.cu", "scan_commit.cu", "scan_commit.cu"]
    assert "-DSCAN_TIE_LAST=1" in calls[2][1] and "-DSCAN_TIE_LAST=1" not in calls[1][1]
    names = sorted(n.split("-")[0] for n in os.listdir(cache_dir) if n.endswith(".kscc"))
    assert names == ["capacity", "scan_commit", "scan_commit_tie_last"]
    _new_process(monkeypatch, cache_dir)
    for name in ("scan_commit_tie_last", "capacity", "scan_commit"):
        kb.load_cuda_library(name)
    assert len(calls) == 3 and kb.build_stats["hits"] == 3


def test_triton_cache_dir_follows_the_cache_unless_set(tmp_path, monkeypatch):
    monkeypatch.delenv("TRITON_CACHE_DIR")
    enable_compilation_cache(str(tmp_path / "kscc"))
    assert os.environ["TRITON_CACHE_DIR"] == str(tmp_path / "kscc" / "cpu" / "triton")
    assert kb.triton_cache_dir() == str(tmp_path / "kscc" / "cpu" / "triton")


def test_cache_status_and_metrics(tmp_path, monkeypatch):
    calls: list = []
    monkeypatch.setattr(kb, "run_nvcc", _stand_in_builder(calls))
    s = Scheduler(SchedulerConfiguration(compile_cache_dir=str(tmp_path / "cc")),
                  device="cpu")
    kb.load_cuda_library("capacity")
    monkeypatch.setattr(kb, "_libs", {})
    import shutil

    shutil.rmtree(kb.BUILD_DIR)
    kb.load_cuda_library("capacity")
    st = s._compile_cache.status()
    assert (st["hits"], st["misses"], st["entries"]) == (1, 1, 1)
    assert s.metrics.compile_cache_hits.get() == 1.0
    assert s.metrics.compile_cache_misses.get() == 1.0
    assert s.metrics.compile_cache_loads._only().count == 1
    # the reference's status keys
    assert set(st) == {"dir", "fingerprint", "hits", "misses", "entries",
                       "serialize_unsupported", "load_p50_s", "load_max_s"}


@pytest.mark.parametrize("value,derived", [("", "state"), ("off", None), ("none", None),
                                           ("explicit", "explicit")])
def test_scheduler_opens_the_cache_as_the_reference(tmp_path, value, derived):
    state = DurableState(str(tmp_path / "st"), snapshot_interval_seconds=0)
    try:
        cfg_dir = str(tmp_path / "explicit") if value == "explicit" else value
        s = Scheduler(SchedulerConfiguration(compile_cache_dir=cfg_dir), state=state,
                      device="cpu")
        if derived is None:
            assert s._compile_cache is None and kb._CACHE is None
        else:
            want = (state.compile_cache_path if derived == "state"
                    else str(tmp_path / "explicit"))
            assert s._compile_cache.dir == want and kb._CACHE is s._compile_cache
            assert state.status()["compile_cache"]["dir"] == want
    finally:
        state.journal.close()


def test_no_cache_without_a_dir(tmp_path):
    s = Scheduler(SchedulerConfiguration(), device="cpu")
    assert s._compile_cache is None and kb._CACHE is None


def test_disable_variable_turns_the_cache_off(tmp_path, monkeypatch):
    monkeypatch.setenv("K8S_TPU_DISABLE_COMPILE_CACHE", "1")
    assert enable_compilation_cache(str(tmp_path / "kscc")) is None
    assert kb._CACHE is None


def test_fingerprint_names_the_toolchain():
    fp = port_cc.backend_fingerprint()
    assert fp.startswith("nvcc") and "-torch" in fp and "-cuda" in fp
    assert fp.split("-")[-1] in ("cpu",) or fp.split("-")[-1].startswith("sm")


def test_loaded_library_is_a_ctypes_handle(tmp_path, monkeypatch):
    calls: list = []
    monkeypatch.setattr(kb, "run_nvcc", _stand_in_builder(calls, answer=7))
    _new_process(monkeypatch, tmp_path / "kscc")
    assert isinstance(kb.load_cuda_library("guard_sweep"), ctypes.CDLL)
