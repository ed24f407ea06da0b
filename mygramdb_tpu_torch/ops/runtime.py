"""Device choice, dispatch and launch counters, and the CUDA kernel build.

- ``device()``: the torch device a ``DeviceIndex`` lives on, from
  ``MYGRAM_TORCH_DEVICE`` (default ``cuda``). Asking for CUDA where there is
  none raises; nothing falls back to the CPU. Tests set ``cpu`` themselves.
- ``dispatches``: the process-wide count of device programs issued by the
  ops layer, bumped at the same call sites as in the JAX package.
- ``launches``: one plain integer per hand-written kernel, bumped by its
  wrapper where it launches the kernel and nowhere else; ``launch_forms``
  counts the K1 launches that carry NOT rows or filter rows; ``routes``
  counts the queries each device route of the index served.
- ``kernel_error``: what a wrapper raises when its kernel refuses its
  inputs or fails to launch (see ``errors.py``).
- ``kernels()``: builds ``csrc/*.cu`` with ``nvcc`` for ``sm_90a`` into a
  plain-C shared library (keyed by a hash of the sources) and loads it with
  ctypes. ``DeviceIndex`` calls it when built on CUDA, so a failed build
  fails table construction, not a query.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import numpy as np
import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def device() -> torch.device:
    """The device new index segments are placed on. Raises when CUDA is
    asked for and absent."""
    dev = torch.device(os.environ.get("MYGRAM_TORCH_DEVICE", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "MYGRAM_TORCH_DEVICE names a CUDA device but torch finds none "
            "(set MYGRAM_TORCH_DEVICE=cpu to run on the CPU)")
    return dev


def to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host numpy -> a tensor on ``dev`` that shares no memory with ``a``.
    uint32 words travel as their int32 bit pattern (torch's uint32 has no
    shifts or NOT)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if dev.type == "cpu" or not a.flags.writeable:
        return torch.tensor(a, device=dev)  # a copy
    return torch.from_numpy(a).to(dev)


class _DispatchCounter:
    """Process-wide count of device programs issued by the ops layer (the
    JAX package's contract: one per search, verify or top-n entry point),
    so ``tests/test_dispatch_counts.py``'s bounds keep their meaning."""

    __slots__ = ("count",)

    def __init__(self) -> None:
        self.count = 0

    def bump(self, n: int = 1) -> None:
        self.count += n


dispatches = _DispatchCounter()

# kernel name -> launches; reset by callers that measure a window
launches: Dict[str, int] = {"dense_and": 0, "slice_gather": 0}
# K1 launches by the optional inputs they carried
launch_forms: Dict[str, int] = {"dense_and.not_rows": 0,
                                "dense_and.extra_rows": 0}
# device route -> queries it served (bumped where the route runs)
routes: Dict[str, int] = {"dense_batched": 0, "dense_unbatched": 0,
                          "sparse_batched": 0, "sparse_unbatched": 0}
_launch_lock = threading.Lock()  # batches flush on many worker threads


def reset_launches() -> None:
    with _launch_lock:
        for counts in (launches, launch_forms, routes):
            for k in counts:
                counts[k] = 0


def count_route(name: str, queries: int = 1) -> None:
    with _launch_lock:
        routes[name] += queries


def kernel_error(msg: str) -> Exception:
    """A kernel wrapper's failure, as the pipeline's own error class."""
    from .errors import KernelError  # the pipeline's import chain reaches ops
    return KernelError(msg)


# ---------------------------------------------------------------------------
# Kernel build and load
# ---------------------------------------------------------------------------

_build_lock = threading.Lock()
_lib = None
build_log = ""   # nvcc's output of the last build in this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _build() -> Path:
    global build_log
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libmygram_torch_{h.hexdigest()[:16]}.so"
    if lib.is_file():
        return lib
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, lib)
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.mygram_dense_and.argtypes = [p, i64, p, i32, p, i32, p, i32, p,
                                     p, p, i32, p]
    lib.mygram_dense_and.restype = i32
    lib.mygram_slice_gather.argtypes = [p, i64, p, p, i32, i32, p, p]
    lib.mygram_slice_gather.restype = i32
    lib.mygram_error_string.argtypes = [i32]
    lib.mygram_error_string.restype = ctypes.c_char_p
    return lib


def kernels() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    with _build_lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(_build())))
    return _lib


def check_launch(err: int, name: str, forms=()) -> None:
    """Raise on a refused or failed launch (the C entry points return
    ``cudaGetLastError()``); count the launch, and its ``forms``,
    otherwise."""
    if err != 0:
        msg = kernels().mygram_error_string(err).decode()
        raise kernel_error(f"{name} kernel launch failed: {msg} ({err})")
    with _launch_lock:
        launches[name] += 1
        for f in forms:
            launch_forms[f] += 1


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A kernel wrapper's device check: every tensor on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise kernel_error(f"{name}: tensors must share one CUDA "
                               f"device, got {[str(x.device) for x in tensors]}")
