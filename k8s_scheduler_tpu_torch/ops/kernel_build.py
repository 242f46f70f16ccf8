"""Building and counting the port's hand-written kernels.

CUDA C++ sources under `csrc/` are compiled with nvcc for `sm_90a` into
shared libraries with a plain C interface, loaded with ctypes, at first
use, into `k8s_scheduler_tpu_torch/_build/` (git-ignored). A library is
named after a hash of its source and flags, so an edited source never
reuses a stale build. Triton kernels compile into `<build dir>/triton/`
unless TRITON_CACHE_DIR says otherwise (`triton_cache_dir`).

With the persistent kernel cache open (`open_cache`, which
`utils/compilation_cache.enable_compilation_cache` and a `Scheduler` with
`compileCacheDir` call), the process builds into that cache's directory
instead, and every library goes through `core/compile_cache.CompileCache`:
a hit writes the verified payload under the library's hashed name (tmp,
fsync, rename) and loads it; a miss, or an entry refused as torn, runs
nvcc and stores the result. `build_stats` counts a process's nvcc runs,
hits, misses and load seconds. A library already loaded in the process is
never reloaded.

`launch_counts` counts, per kernel, the launches each wrapper made; a
caller resets it before a run to show which kernels that run went
through. `HARNESS_KERNELS` are builds of a source with a deliberate
engine mutation (`fuzz/replay.py engine_bug`), built and launched only
while the mutation is active (`TIE_LAST`), under their own names, and
counted in `harness_launch_counts`."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# every CUDA source under csrc/ and its extra flags: --fmad=false keeps each
# multiply and add separately rounded where the reference's arithmetic is
# reproduced bit for bit
CUDA_KERNELS: dict[str, tuple[str, ...]] = {
    "static_base": ("--fmad=false",),
    "interpod_terms": ("--fmad=false",),
    "affinity_update": (),
    "capacity": ("--fmad=false",),
    "guard_sweep": (),
    "preempt_prefilter": ("--fmad=false",),
    "preempt_whatif": ("--fmad=false",),
    "preempt_claim": ("--fmad=false",),
    "volume_mask": ("--fmad=false",),
    "pv_choice": ("--fmad=false",),
    "pv_fold": ("--fmad=false",),
    "scan_commit": ("--fmad=false",),
    "dyn_round": ("--fmad=false",),
    "static_rejects": (),
    "dyn_rejects": ("--fmad=false",),
}

# name -> (source under csrc/, flags): the fuzz harness's last-max
# tie-break of K13 and K9 (fuzz/replay.py engine_bug("tiebreak"))
HARNESS_KERNELS: dict[str, tuple[str, tuple[str, ...]]] = {
    "scan_commit_tie_last": ("scan_commit", ("--fmad=false", "-DSCAN_TIE_LAST=1")),
    "preempt_claim_tie_last": ("preempt_claim", ("--fmad=false", "-DCLAIM_TIE_LAST=1")),
}
# set while engine_bug("tiebreak") is active: the scan and the preemption
# claim launch their HARNESS_KERNELS instance
TIE_LAST = False

launch_counts: dict[str, int] = {
    "static_base": 0, "claim_pass": 0, "interpod_terms": 0, "interpod_norm": 0,
    "affinity_update": 0, "capacity": 0, "guard_sweep": 0,
    "preempt_prefilter": 0, "preempt_whatif": 0, "preempt_claim": 0,
    "volume_mask": 0, "pv_choice": 0, "pv_fold": 0, "scan_commit": 0,
    "dyn_mask": 0, "dyn_score": 0, "static_rejects": 0, "dyn_rejects": 0,
    "extender_merge": 0, "static_base_ext": 0, "static_rejects_base": 0,
}
# the HARNESS_KERNELS' launches, apart from the main path's
harness_launch_counts: dict[str, int] = dict.fromkeys(HARNESS_KERNELS, 0)
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # nvcc's -Xptxas=-v report per fresh build
# this process's library builds: nvcc runs, cache hits and misses, seconds
# spent taking hits from the cache
build_stats: dict[str, float] = {"nvcc": 0, "hits": 0, "misses": 0, "load_s": 0.0}
_stats_lock = threading.Lock()
_CACHE = None  # core/compile_cache.CompileCache while a cache is open


def reset_launch_counts() -> None:
    for counts in (launch_counts, harness_launch_counts):
        for k in counts:
            counts[k] = 0


def count_launch(name: str) -> None:
    (harness_launch_counts if name in harness_launch_counts else launch_counts)[name] += 1


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _count(field: str, amount: float = 1) -> None:
    with _stats_lock:
        build_stats[field] += amount


def triton_cache_dir() -> str:
    """Where Triton compiles its kernels: TRITON_CACHE_DIR, set to
    `<build dir>/triton` unless the environment already sets it. Called
    before a Triton kernel's first launch."""
    return os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))


def set_build_dir(path) -> None:
    """Build (and take cache hits) into `path` from now on. Libraries this
    process already loaded stay loaded."""
    global BUILD_DIR
    BUILD_DIR = Path(path)


def open_cache(cache) -> None:
    """Route every later library load through `cache` (a
    `core/compile_cache.CompileCache`); None closes it."""
    global _CACHE
    _CACHE = cache


def _spec(name: str) -> tuple[str, tuple[str, ...]]:
    """(source name, flags without the include path) of library `name`."""
    if name in HARNESS_KERNELS:
        base, extra = HARNESS_KERNELS[name]
        return base, NVCC_FLAGS + extra
    return name, NVCC_FLAGS + CUDA_KERNELS[name]


def _target(name: str, src: Path | None = None, include: Path | None = None):
    """(source, its flags with the include path, the text the build
    depends on, the flags without the path, <build dir>/lib<name>-<hash>.so)
    of library `name`; the hash covers the source, the headers of
    `include` and the flags, not where the checkout lies."""
    base, flags0 = _spec(name)
    src = src or CSRC_DIR / f"{base}.cu"
    include = include or src.parent
    text = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(include.glob("*.cuh")))
    digest = hashlib.sha1(text + repr(flags0).encode()).hexdigest()[:12]
    return src, flags0 + (f"-I{include}",), text, flags0, BUILD_DIR / f"lib{name}-{digest}.so"


def run_nvcc(src: Path, flags: tuple[str, ...], out: Path) -> str:
    """nvcc `src` with `flags` into the shared library `out`; its stderr
    (the -Xptxas=-v report)."""
    proc = subprocess.run([nvcc_path(), *flags, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stdout}\n{proc.stderr}")
    return proc.stderr


def _build(name: str, src: Path, flags: tuple[str, ...], out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # per process and thread: an earlier checkout's identical source builds
    # to the same library in another thread at once
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    log = run_nvcc(src, flags, tmp)
    os.replace(tmp, out)
    _count("nvcc")
    build_logs[name if src.parent == CSRC_DIR else str(src)] = log


def build_cuda_library(name: str, src: Path | None = None,
                       include: Path | None = None) -> Path:
    """Compile csrc/<name>.cu (a HARNESS_KERNELS name: its source with its
    flags), or the source `src` with <name>'s flags and the headers of
    `include` (default: the source's own directory), into
    <build dir>/lib<name>-<hash>.so, unless that file exists."""
    src, flags, _, _, out = _target(name, src, include)
    if not out.exists():
        _build(name, src, flags, out)
    return out


def _through_cache(name: str, cc) -> Path:
    """csrc/<name>'s library by way of the open cache: a hit lands the
    verified payload under the library's hashed name; a miss (an entry
    refused as torn among them) runs nvcc and stores the result. A file
    already in the build directory is not trusted: it was not verified."""
    from ..core.compile_cache import cache_key

    src, flags, text, flags0, out = _target(name)
    key = cache_key(name, hashlib.sha256(text).hexdigest()[:16], flags0, cc._fingerprint)
    t0 = time.perf_counter()
    payload = cc.load(key)
    if payload is not None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, out)
        dt = time.perf_counter() - t0
        cc.note_hit(dt)
        _count("hits")
        _count("load_s", dt)
        return out
    cc.note_miss()
    _count("misses")
    t0 = time.perf_counter()
    _build(name, src, flags, out)
    cc.store(key, out.read_bytes(), build_seconds=time.perf_counter() - t0)
    return out


def load_cuda_library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        cc = _CACHE
        path = build_cuda_library(name) if cc is None else _through_cache(name, cc)
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib


def checked(kernel: str, t: torch.Tensor, dtype: torch.dtype, shape,
            device: torch.device) -> torch.Tensor:
    """`t` as a contiguous kernel argument, or ValueError if its dtype,
    shape or device is not what the kernel takes."""
    if t.dtype != dtype or t.device != device or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: want {dtype} {tuple(shape)} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_of(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on_error(kernel: str, err: int) -> None:
    """A C launcher returns cudaGetLastError() after its launches."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
