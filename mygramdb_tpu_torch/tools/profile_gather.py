"""Validate and time the slice gather, the compaction pieces and the row
gather on the card (port of ``e2e/profile_gather.py``).

    python -m mygramdb_tpu_torch.tools.profile_gather

The probe serves no query. It holds two hand-written kernels against
their plain PyTorch versions and times both with CUDA events: the CSR
slice gather (K3, ``ops.posting_ops.gather_slices``) and the row gather
(P1, ``gather_rows`` below: ``out[i, :] = padded[ids[i], :]``, the copy of
R rows of a padded text matrix; ``csrc/row_gather.cu``), the latter also
beside ``torch.index_select``, the one PyTorch call for the same function.
Between them it times three ways to compact a masked (B, C) candidate
tile, as torch ops: the cumsum alone, a rank scatter and a top-k of
negated keys.

It runs on ``MYGRAM_TORCH_DEVICE`` (default ``cuda``). On the CPU the
wrappers take the plain versions and the clock is the host's; every line
names the device its times were taken on.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Callable, List

import torch

from ..ops import runtime
from ..ops.posting_ops import SENTINEL, _gather_slices_plain, gather_slices


def _gather_rows_plain(padded: torch.Tensor, ids: torch.Tensor
                       ) -> torch.Tensor:
    """Plain PyTorch version of P1 (same signature as ``gather_rows``)."""
    return padded[ids.long()]


def gather_rows(padded: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """P1 wrapper: padded (N, rowT) of any element type, ids (R,) int32 in
    [0, N) -> (R, rowT), ``out[i] = padded[ids[i]]``.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which copies 16 bytes a thread: a row's bytes must be a multiple of 16
    and the matrix contiguous and 16-byte aligned."""
    if padded.device.type == "cpu":
        return _gather_rows_plain(padded, ids)
    runtime.require_cuda("gather_rows", padded, ids)
    if padded.dim() != 2 or ids.dim() != 1 or ids.dtype != torch.int32:
        raise runtime.kernel_error(
            "gather_rows: padded (N, rowT), ids (R,) int32")
    if not (padded.is_contiguous() and ids.is_contiguous()):
        raise runtime.kernel_error("gather_rows: tensors must be contiguous")
    row_bytes = padded.shape[1] * padded.element_size()
    if row_bytes % 16 or padded.data_ptr() % 16:
        raise runtime.kernel_error(
            f"gather_rows: a row of {row_bytes} bytes; rows must be a "
            "multiple of 16 bytes and the matrix 16-byte aligned")
    out = torch.empty((ids.shape[0], padded.shape[1]), dtype=padded.dtype,
                      device=padded.device)
    if out.numel() == 0:
        return out
    err = runtime.launch_on(
        padded, runtime.kernels().mygram_gather_rows, padded.data_ptr(),
        row_bytes, ids.data_ptr(), ids.shape[0], out.data_ptr())
    runtime.check_launch(err, "row_gather")
    return out


def timeit(fn: Callable[[], object], dev: torch.device, warm: int = 2,
           iters: int = 6) -> float:
    """Median milliseconds of fn(): CUDA events on the card, the host
    clock on the CPU."""
    for _ in range(warm):
        fn()
    lat = []
    for _ in range(iters):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            lat.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            lat.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(lat)


def scatter_compact(cands: torch.Tensor, mask: torch.Tensor,
                    k: int) -> torch.Tensor:
    """The first k masked candidates of each row by rank scatter,
    SENTINEL padded: (B, C) -> (B, k)."""
    rank = torch.cumsum(mask.to(torch.int32), dim=-1) - 1
    idx = torch.where(mask & (rank < k), rank, k).long()
    sel = torch.full((cands.shape[0], k + 1), SENTINEL, dtype=torch.int32,
                     device=cands.device)
    return sel.scatter_(1, idx, cands)[:, :k]


def topk_compact(cands: torch.Tensor, mask: torch.Tensor,
                 k: int) -> torch.Tensor:
    """The k smallest masked candidates of each row by a top-k of negated
    keys, SENTINEL padded: (B, C) -> (B, k)."""
    low = -(2 ** 31) + 1
    vals = torch.topk(torch.where(mask, -cands, low), k, dim=-1).values
    return torch.where(vals > low, -vals, SENTINEL)


def main(argv=None, out: Callable[[str], None] = print) -> List[dict]:
    """Run the probe; prints one line per measurement through ``out`` and
    returns them as records."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--postings", type=int, default=50_000_000)
    ap.add_argument("--slice-width", type=int, default=16384)
    ap.add_argument("--cands", type=int, default=4096)
    ap.add_argument("--rows", type=int, default=1_130_496,
                    help="rows of the padded matrix")
    ap.add_argument("--row-cells", type=int, default=1024)
    ap.add_argument("--gathered", type=int, default=64 * 2048,
                    help="rows the row gather copies")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = runtime.device()
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    records: List[dict] = []

    def report(what: str, ms: float, nbytes: int = 0) -> None:
        rec = {"what": what, "ms": ms, "device": name}
        line = f"{what:<36}{ms:10.4f} ms"
        if nbytes:
            rec["gb_per_s"] = nbytes / 1e9 / (ms / 1e3)
            line += f"  [{nbytes / 1e9:.3f} GB -> {rec['gb_per_s']:.0f} GB/s]"
        records.append(rec)
        out(line)

    def rand(lo, hi, size, dtype=torch.int32):
        return torch.randint(lo, hi, size, dtype=dtype, device=dev,
                             generator=gen)

    out(f"# device={name}")
    B, Ks, C, Cmax = 64, 8, args.cands, args.slice_width
    k_out = C // 2
    P = args.postings
    post = torch.sort(rand(1, 1_100_000, (P,))).values
    offs = rand(0, P - Cmax, (B * Ks,), torch.int64)
    lens = torch.full((B * Ks,), min(9000, Cmax), dtype=torch.int64,
                      device=dev)

    # correctness first
    if not torch.equal(gather_slices(post, offs, lens, Cmax),
                       _gather_slices_plain(post, offs, lens, Cmax)):
        raise AssertionError("slice gather kernel mismatch")
    out("slice gather parity OK")
    nbytes = B * Ks * Cmax * 4
    report("slice gather kernel (BKs x Cmax):",
           timeit(lambda: gather_slices(post, offs, lens, Cmax), dev), nbytes)
    report("slice gather plain  (BKs x Cmax):",
           timeit(lambda: _gather_slices_plain(post, offs, lens, Cmax), dev))
    del post

    # compaction pieces at (B, C)
    mask = torch.rand((B, C), device=dev, generator=gen) < 0.15
    cands = rand(0, 1 << 20, (B, C))
    want = torch.sort(torch.where(mask, cands, SENTINEL), dim=-1
                      ).values[:, :k_out]
    if not torch.equal(topk_compact(cands, mask, k_out), want) or \
            not torch.equal(torch.sort(scatter_compact(cands, mask, k_out),
                                       dim=-1).values, want):
        raise AssertionError("compaction mismatch")
    report("cumsum (B x C):", timeit(
        lambda: torch.cumsum(mask.to(torch.int32), dim=-1), dev))
    report("scatter compact:", timeit(
        lambda: scatter_compact(cands, mask, k_out), dev))
    report("top_k compact:", timeit(
        lambda: topk_compact(cands, mask, k_out), dev))

    # row gather
    N, rowT, R = args.rows, args.row_cells, args.gathered
    # u16 cells as int16 bit patterns, as the text store holds them
    padded = rand(-2 ** 15, 2 ** 15, (N, rowT), torch.int16)
    ids = rand(0, N, (R,))
    got = gather_rows(padded, ids)
    if not torch.equal(got, _gather_rows_plain(padded, ids)):
        raise AssertionError("row gather kernel mismatch")
    out("row gather parity OK")
    del got
    nbytes = 2 * R * rowT * padded.element_size()
    report("row gather kernel (R x rowT):",
           timeit(lambda: gather_rows(padded, ids), dev), nbytes)
    report("row gather plain:",
           timeit(lambda: _gather_rows_plain(padded, ids), dev), nbytes)
    report("row gather index_select:",
           timeit(lambda: torch.index_select(padded, 0, ids), dev), nbytes)
    return records


if __name__ == "__main__":
    main()
    sys.exit(0)
