"""The persistent kernel cache's process entry (the port of
`k8s_scheduler_tpu/utils/compilation_cache.py`).

A process that rebuilt every kernel at start would pay 15 nvcc builds (38.6
s in parallel on an H100 host, PERF.md) on every restart and every standby
takeover. `enable_compilation_cache` points the process's build directory
inside a persistent tree and opens the KSCC store there
(`core/compile_cache.CompileCache`), so a warm restart takes its libraries
from the store and runs no nvcc."""

from __future__ import annotations

import os


def enable_compilation_cache(path: str, metrics=None):
    """Open the kernel cache at `path` for this process: the KSCC entries
    under `path`, the libraries built and loaded under `<path>/<sm
    capability>` (one directory per card generation), Triton's own cache
    under `<path>/<sm capability>/triton` unless TRITON_CACHE_DIR is
    already set (Triton keys its entries itself; they are not KSCC-framed).
    Returns the `CompileCache`. `K8S_TPU_DISABLE_COMPILE_CACHE=1` turns it
    off (returns None), as in the reference."""
    from ..core.compile_cache import CompileCache, sm_capability
    from ..ops import kernel_build

    if os.environ.get("K8S_TPU_DISABLE_COMPILE_CACHE") == "1":
        return None
    build = os.path.join(path, sm_capability())
    os.makedirs(build, exist_ok=True)
    kernel_build.set_build_dir(build)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    cc = CompileCache(path, metrics=metrics)
    kernel_build.open_cache(cc)
    return cc
