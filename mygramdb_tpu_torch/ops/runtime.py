"""Device choice, dispatch and launch counters, and the CUDA kernel build.

- ``device()``: the torch device a ``DeviceIndex`` lives on, from
  ``MYGRAM_TORCH_DEVICE`` (default ``cuda``). Asking for CUDA where there is
  none raises; nothing falls back to the CPU. Tests set ``cpu`` themselves.
- ``dispatches``: the process-wide count of device programs issued by the
  ops layer, bumped at the same call sites as in the JAX package.
- ``launches``: one plain integer per hand-written kernel, bumped by its
  wrapper where it launches the kernel and nowhere else; ``launch_forms``
  counts the K1 launches that carry NOT rows or filter rows or take the
  first n doc ids (``dense_and.topn``), the K2
  launches by their operation, the sparse-probe launches by their output
  (``sparse_probe.topn`` / ``.compact`` / ``.masked``) and those that
  probe nothing (``.probe_free``), the slice gathers of the positional
  program (``slice_gather.positional``), the window-TF launches in non-overlapping
  mode and the K6 launches that read whole matrix rows (the text store's
  calls); ``launch_shapes`` counts the K2 launches by (op, B, K, W),
  the sparse-probe launches by (form, B, C, Ks, Kd, width, probes) and
  the boolean-program launches by (T, K, S, ops, W);
  ``routes`` counts the queries each device route of the index served;
  ``launches_by_device`` and ``launches_by_shard`` count every launch
  and its forms again by the card it ran on and, inside a mesh program
  (``on_shard``), by the shard it ran for.
- ``overflow``: always on, never reset, on ``INFO`` and ``/metrics``:
  ``verify_overflow_queries``, the fused verified queries that had
  candidates among the text store's overflow documents, and
  ``verify_overflow_candidates``, those documents, verified or scored on
  the host (``count_overflow``). ``text_store_bytes``: each table's text
  store's device bytes, set where the store is built; the gauge
  ``text_store_bytes`` is their sum.
- ``kernel_error``: what a wrapper raises when its kernel refuses its
  inputs or fails to launch (see ``errors.py``).
- ``kernels()``: builds ``csrc/*.cu`` with ``nvcc`` for ``sm_90a`` (one
  compiler process per source, all started together) into a plain-C
  shared library, keyed by a hash of the sources and headers, and loads it
  with ctypes. ``DeviceIndex`` calls it when built on CUDA, so a failed
  build fails table construction, not a query. ``kernel_builds`` counts
  the builds nvcc ran in this process; the first load is the build stage
  ``build.kernels`` (``utils.trace``), its attribute ``built`` telling an
  nvcc build from a load of a library built before.
- ``launch_on(t, entry, *args)``: every C entry point is called through
  it, with ``t``'s device current and ``t``'s current stream as the last
  argument, so a launch lands on the card that holds its tensors; the
  kernels keep their SM counts, attributes and grid memos per device
  (``csrc/per_device.cuh``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ..utils import trace

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
NVCC_LINK_FLAGS = ["-shared", "-gencode", "arch=compute_90a,code=sm_90a"]


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
launches: Dict[str, int] = {"dense_and": 0, "reduce_rows": 0,
                            "ast_words": 0, "slice_gather": 0,
                            "sparse_probe": 0, "tf_rows_flat": 0,
                            "tf_rows_flat_global": 0, "tf_rows_padded": 0,
                            "row_gather": 0}
# launches by the optional inputs or modes they carried
launch_forms: Dict[str, int] = {"dense_and.not_rows": 0,
                                "dense_and.extra_rows": 0,
                                "dense_and.topn": 0,
                                "reduce_rows.and": 0, "reduce_rows.or": 0,
                                "sparse_probe.topn": 0,
                                "sparse_probe.compact": 0,
                                "sparse_probe.masked": 0,
                                "sparse_probe.probe_free": 0,
                                "slice_gather.positional": 0,
                                "tf_rows.nonoverlap": 0,
                                "tf_rows_padded.whole_rows": 0}
# kernel name -> {shape of the call: launches}, for the kernels whose
# reported shape is the one the served queries launched most
launch_shapes: Dict[str, Dict[tuple, int]] = {"reduce_rows": {},
                                               "sparse_probe": {},
                                               "ast_words": {}}
# device route -> queries it served (bumped where the route runs):
# fused_dense / fused_sparse are the fused verified programs, fused_clipped
# the queries they handed back to the exact path (pre > Kv), verify_exact
# the text-store calls (verify, contains, TF, BM25 top-n) of that path;
# ast_device the boolean trees evaluated on the device, ast_host those
# handed back to the host by size (a leaf's slice past the last candidate
# bucket); threshold_merge / threshold_bitmap the two fuzzy candidate
# programs; or_rows the unions. On a doc-sharded mesh the mesh_* routes
# take their place: mesh_dense (batched or not), mesh_sparse,
# mesh_fused_sparse, mesh_fused_dense, mesh_ast, mesh_or; mesh_to_exact
# counts the verified queries a mesh hands to the exact path because no
# sharded program takes them (the flat text layout, which is not sharded,
# or a non-overlapping count with a sparse driver); threshold_host the
# fuzzy candidate counts made on the host (on a mesh, as in the JAX
# package)
routes: Dict[str, int] = {"dense_batched": 0, "dense_unbatched": 0,
                          "sparse_batched": 0, "sparse_unbatched": 0,
                          "fused_dense": 0, "fused_sparse": 0,
                          "fused_clipped": 0, "verify_exact": 0,
                          "ast_device": 0, "ast_host": 0,
                          "threshold_merge": 0, "threshold_bitmap": 0,
                          "or_rows": 0, "mesh_dense": 0, "mesh_sparse": 0,
                          "mesh_fused_sparse": 0, "mesh_fused_dense": 0,
                          "mesh_ast": 0, "mesh_or": 0, "mesh_to_exact": 0,
                          "threshold_host": 0}
# the fused verified queries with overflow candidates, and those
# candidates (count_overflow)
overflow: Dict[str, int] = {"verify_overflow_queries": 0,
                            "verify_overflow_candidates": 0}
# table -> device bytes of its text store
text_store_bytes: Dict[str, int] = {}
# device ("cuda:1") -> {kernel or form: launches}; shard -> the same
launches_by_device: Dict[str, Dict[str, int]] = {}
launches_by_shard: Dict[int, Dict[str, int]] = {}
_launch_lock = threading.Lock()  # batches flush on many worker threads
_tls = threading.local()  # the launching thread's device and shard


def reset_launches() -> None:
    with _launch_lock:
        for counts in (launches, launch_forms, routes):
            for k in counts:
                counts[k] = 0
        for shapes in launch_shapes.values():
            shapes.clear()
        launches_by_device.clear()
        launches_by_shard.clear()


@contextmanager
def on_shard(shard):
    """Count the launches made inside the block for mesh shard ``shard``
    (``launches_by_shard``; None counts for no shard)."""
    prev = getattr(_tls, "shard", None)
    _tls.shard = shard
    try:
        yield
    finally:
        _tls.shard = prev


def count_route(name: str, queries: int = 1) -> None:
    with _launch_lock:
        routes[name] += queries


def count_overflow(candidates: int) -> None:
    """A fused verified query verified or scored ``candidates`` overflow
    documents on the host."""
    with _launch_lock:
        overflow["verify_overflow_queries"] += 1
        overflow["verify_overflow_candidates"] += candidates


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
kernel_builds = 0  # nvcc builds run in this process (under _build_lock)


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
    """Compile each source with its own nvcc, all started together, then
    link them into one shared library (skipped when it exists)."""
    global build_log, kernel_builds
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libmygram_torch_{h.hexdigest()[:16]}.so"
    if lib.is_file():
        return lib
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    nvcc = _nvcc()
    kernel_builds += 1
    objs = [BUILD_DIR / f".{s.stem}.{tag}.o" for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(logs)
    failed = [(s.name, p.returncode) for s, p in zip(srcs, procs)
              if p.returncode != 0]
    tmp = BUILD_DIR / f".{lib.name}.{tag}.tmp"
    if not failed:
        link = subprocess.run([nvcc, *NVCC_LINK_FLAGS, "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            failed.append(("link", link.returncode))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed {failed}:\n{build_log}")
    os.replace(tmp, lib)
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.mygram_dense_and_topn.argtypes = [p, i64, p, i32, p, i32, p, i32,
                                          p, p, i32, i32, p, i32, p]
    lib.mygram_dense_and_topn.restype = i32
    lib.mygram_reduce_rows.argtypes = [p, i64, p, i32, i32, p, i32, p]
    lib.mygram_reduce_rows.restype = i32
    lib.mygram_gather_rows.argtypes = [p, i64, p, i64, p, p]
    lib.mygram_gather_rows.restype = i32
    lib.mygram_slice_gather.argtypes = [p, i64, p, p, i32, i32, p, p]
    lib.mygram_slice_gather.restype = i32
    lib.mygram_sparse_probe.argtypes = [p, i64, p, i64, p, p, i32, p, i32,
                                        i32, i32, i32, i32, i32, p, i64, p,
                                        i64, i32, i32, i32, p]
    lib.mygram_sparse_probe.restype = i32
    lib.mygram_ast_words.argtypes = [p, i64, p, i64, p, p, p, i32, i32, i32,
                                     i32, i32, i64, p, p]
    lib.mygram_ast_words.restype = i32
    lib.mygram_tf_rows.argtypes = [p, i32, i64, p, p, p, p, p, p,
                                   i32, i32, i32, i32, i32, i32, i32, i32,
                                   i32, p, p]
    lib.mygram_tf_rows.restype = i32
    lib.mygram_error_string.argtypes = [i32]
    lib.mygram_error_string.restype = ctypes.c_char_p
    return lib


def kernels() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    with _build_lock:
        if _lib is None:
            with trace.stage("build.kernels") as st:
                before = kernel_builds
                _lib = _bind(ctypes.CDLL(str(_build())))
                st.set(built=kernel_builds > before)
    return _lib


def check_launch(err: int, name: str, forms=(), shape=None) -> None:
    """Raise on a refused or failed launch (the C entry points return
    ``cudaGetLastError()``); count the launch, its ``forms`` and its
    ``shape``, otherwise."""
    if err != 0:
        msg = kernels().mygram_error_string(err).decode()
        raise kernel_error(f"{name} kernel launch failed: {msg} ({err})")
    with _launch_lock:
        launches[name] += 1
        for f in forms:
            launch_forms[f] += 1
        keys = (name, *forms)
        views = [launches_by_device.setdefault(
            getattr(_tls, "device", "?"), {})]
        shard = getattr(_tls, "shard", None)
        if shard is not None:
            views.append(launches_by_shard.setdefault(shard, {}))
        for view in views:
            for k in keys:
                view[k] = view.get(k, 0) + 1
        if shape is not None:
            shapes = launch_shapes[name]
            shapes[shape] = shapes.get(shape, 0) + 1


def launch_on(t: torch.Tensor, entry, *args) -> int:
    """Call the C entry point ``entry(*args, stream)`` with ``t``'s device
    current and ``stream`` its current stream: the device guard of every
    launch. -> the entry's error code."""
    idx = t.device.index
    _tls.device = str(t.device)
    with torch.cuda.device(idx):
        return entry(*args, torch._C._cuda_getCurrentRawStream(idx))


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A kernel wrapper's device check: every tensor on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise kernel_error(f"{name}: tensors must share one CUDA "
                               f"device, got {[str(x.device) for x in tensors]}")
