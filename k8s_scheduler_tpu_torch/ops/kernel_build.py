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
import threading
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

launch_counts: dict[str, int] = {
    "static_base": 0, "claim_pass": 0, "interpod_terms": 0, "interpod_norm": 0,
    "affinity_update": 0, "capacity": 0, "guard_sweep": 0,
    "preempt_prefilter": 0, "preempt_whatif": 0, "preempt_claim": 0,
    "volume_mask": 0, "pv_choice": 0, "pv_fold": 0, "scan_commit": 0,
    "dyn_mask": 0, "dyn_score": 0, "static_rejects": 0, "dyn_rejects": 0,
    "extender_merge": 0, "static_base_ext": 0, "static_rejects_base": 0,
}
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # nvcc's -Xptxas=-v report per fresh build


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


def build_cuda_library(name: str, src: Path | None = None,
                       include: Path | None = None) -> Path:
    """Compile csrc/<name>.cu, or the source `src` with <name>'s flags and
    the headers of `include` (default: the source's own directory), into
    _build/lib<name>-<hash>.so (cached; the hash covers the source, those
    headers and the flags)."""
    src = src or CSRC_DIR / f"{name}.cu"
    include = include or src.parent
    flags = NVCC_FLAGS + CUDA_KERNELS[name] + (f"-I{include}",)
    text = src.read_bytes() + b"".join(h.read_bytes()
                                       for h in sorted(include.glob("*.cuh")))
    digest = hashlib.sha1(text + repr(flags).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # per process and thread: an earlier checkout's identical source
        # builds to the same library in another thread at once
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run(
            [nvcc_path(), *flags, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src.name}:\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
        build_logs[name if src.parent == CSRC_DIR else str(src)] = proc.stderr
    return out


def load_cuda_library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_cuda_library(name)))
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
