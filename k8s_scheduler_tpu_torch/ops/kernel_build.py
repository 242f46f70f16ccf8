"""Building and counting the port's hand-written kernels.

CUDA C++ sources under `csrc/` are compiled with nvcc for `sm_90a` into
shared libraries with a plain C interface, loaded with ctypes, at first
use, into `k8s_scheduler_tpu_torch/_build/` (git-ignored). A library is
named after a hash of its source and flags, so an edited source never
reuses a stale build. Triton kernels compile into `_build/triton/` unless
TRITON_CACHE_DIR says otherwise.

`launch_counts` counts, per kernel, the launches each wrapper made; a
caller resets it before a run to show which kernels that run went
through."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
)

launch_counts: dict[str, int] = {"static_base": 0, "claim_pass": 0}
_libs: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def count_launch(name: str) -> None:
    launch_counts[name] += 1


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_cuda_library(name: str, extra_flags: tuple[str, ...] = ()) -> Path:
    """Compile csrc/<name>.cu into _build/lib<name>-<hash>.so (cached)."""
    src = CSRC_DIR / f"{name}.cu"
    flags = NVCC_FLAGS + tuple(extra_flags)
    digest = hashlib.sha1(src.read_bytes() + repr(flags).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc_path(), *flags, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src.name}:\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    return out


def load_cuda_library(name: str, extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_cuda_library(name, extra_flags)))
        _libs[name] = lib
    return lib
