"""Doc-sharded mesh on PyTorch (port of ``mygramdb_tpu.parallel.mesh``).

One process drives a ``(dp, docs)`` grid of torch devices, as the JAX
package's single controller drives its mesh. Shard ``s`` of the docs axis
owns doc ids ``[s * Ds, (s + 1) * Ds)``: its bitmap block ``(V, W / S)``,
its tombstone and filter words, its CSR of shard-local doc ids and its
padded text rows live on its device as tensors of their own
(``ShardedTensor``). Several shards may share a card.

PyTorch has no auto-partitioner, so every route is an explicit program:
the kernels of the single-device path (K1 ``dense_and_topn``, K2
``ast_words`` / ``reduce_rows``, K3 ``sparse_probe``, K6 through
``fused``) run once per shard on the shard's tensors, launched on its
device's current stream, and the shards' small results meet on the home
device (shard 0's) as the JAX collectives meet them:

- counts add (the ``psum``);
- each shard's first n ids, offset by ``s * Ds``, are concatenated and cut
  to n (the ``all_gather`` and merge): ``torch.topk`` for descending,
  the negation for ascending, and two stable sorts (score descending,
  then id descending) for BM25 pages;
- word results (boolean trees, unions, whole bitmaps) concatenate in shard
  order, with no collective at all.

Each program pulls its answer to the host once. No ``torch.distributed``:
a gather of ``S * (1 + n)`` ints needs no process group.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops import runtime
from ..ops.bitmap_ops import ast_words, dense_and_topn, reduce_rows
from ..ops.fused import (_needle_tensors, _needles_need_range,
                         _search_verify_topn_batch,
                         _sparse_search_verify_topn_batch)
from ..ops.posting_ops import pack_sparse_args, sparse_probe
from ..ops.verify_ops import needle_cap_bucket, sort_by_score

_KEY_FLOOR = -(2 ** 31) + 1  # the ascending merge's "no id" key


class Mesh:
    """A ``(dp, docs)`` grid of torch devices; ``shape`` names its axes as
    the JAX mesh does. The index uses one row: ``docs_devices``."""

    def __init__(self, grid: Sequence[Sequence]):
        self.devices = [[torch.device(d) for d in row] for row in grid]
        self.shape = {"dp": len(self.devices), "docs": len(self.devices[0])}

    @property
    def docs_devices(self) -> List[torch.device]:
        return self.devices[0]

    @property
    def home(self) -> torch.device:
        return self.devices[0][0]

    def layout(self) -> str:
        return ", ".join(f"shard {s}: {d}"
                         for s, d in enumerate(self.docs_devices))


def default_devices(n: Optional[int] = None, device=None) -> List[torch.device]:
    """n shard devices on ``device``'s type (``runtime.device()`` by
    default): the CPU n times, or the cards in turn (shard i on card
    i mod the card count), so a host with fewer cards than shards still
    runs every shard."""
    dev = torch.device(device) if device is not None else runtime.device()
    if dev.type != "cuda":
        return [dev] * (n or 1)
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n or cards)]


def make_mesh(n_devices: Optional[int] = None, dp: int = 1,
              devices=None) -> Mesh:
    if devices is None:
        devices = default_devices(n_devices)
    n = len(devices)
    assert n % dp == 0, f"dp={dp} must divide device count {n}"
    docs = n // dp
    return Mesh([devices[r * docs:(r + 1) * docs] for r in range(dp)])


class ShardedTensor:
    """One logical array cut along its doc axis (``axis``) into per-shard
    tensors, each on its shard's device. ``shape``, ``dim()``,
    ``numel()`` and ``cpu()`` answer for the whole array."""

    def __init__(self, parts: Sequence[torch.Tensor], axis: int = 0):
        self.parts = list(parts)
        self.axis = axis

    @property
    def shape(self) -> tuple:
        shape = list(self.parts[0].shape)
        shape[self.axis] = sum(p.shape[self.axis] for p in self.parts)
        return tuple(shape)

    def dim(self) -> int:
        return self.parts[0].dim()

    def numel(self) -> int:
        return sum(p.numel() for p in self.parts)

    def cpu(self) -> torch.Tensor:
        return torch.cat([p.cpu() for p in self.parts], dim=self.axis)


def split_words(words: np.ndarray, devices: Sequence[torch.device],
                axis: int = -1) -> ShardedTensor:
    """Host words (..., W) uint32 -> a ShardedTensor of contiguous
    (..., W / S) int32 blocks on their devices."""
    S = len(devices)
    width = words.shape[axis] // S
    return ShardedTensor([
        runtime.to_device(np.ascontiguousarray(np.take(
            words, range(s * width, (s + 1) * width), axis=axis)), dev)
        for s, dev in enumerate(devices)], axis=axis)


def shard_index_arrays(mesh: Mesh, bitmaps: np.ndarray,
                       deleted: np.ndarray):
    """(V, W) bitmaps and (W,) tombstones, doc-sharded over the docs axis
    and copied to every dp row -> two lists (one per dp row) of
    ShardedTensor."""
    bitmaps, deleted = np.asarray(bitmaps), np.asarray(deleted)
    return ([split_words(bitmaps, row) for row in mesh.devices],
            [split_words(deleted, row) for row in mesh.devices])


def shard_part(x, s: int, S: int, dev: torch.device):
    """Shard s of a word tensor or ShardedTensor on ``dev``: a
    ShardedTensor's part as it is; a (..., W) tensor's s-th block of words,
    contiguous (a view where it already is, a copy across devices)."""
    if x is None:
        return None
    if isinstance(x, ShardedTensor):
        return x.parts[s]
    width = x.shape[-1] // S
    part = x[..., s * width:(s + 1) * width]
    return part.to(dev, non_blocking=True).contiguous()


class _Uploads:
    """One upload of a host int32 array (or None) per distinct device of a
    program."""

    def __init__(self, host: Optional[np.ndarray]):
        self.host = (None if host is None
                     else np.ascontiguousarray(host, dtype=np.int32))
        self.on = {}

    def to(self, dev: torch.device) -> Optional[torch.Tensor]:
        if self.host is not None and dev not in self.on:
            self.on[dev] = runtime.to_device(self.host, dev)
        return self.on.get(dev)


# ---------------------------------------------------------------------------
# The merge (the JAX package's psum + all_gather + top-k / lax.sort)
# ---------------------------------------------------------------------------

def _global_ids(ids: torch.Tensor, shard_docs: int) -> torch.Tensor:
    """(B, S, n) shard-local ids (-1 = none) -> (B, S * n) doc ids."""
    B, S, n = ids.shape
    lo = torch.arange(S, dtype=ids.dtype, device=ids.device) * shard_docs
    return torch.where(ids >= 0, ids + lo[None, :, None], -1).reshape(
        B, S * n)


def merge_ids(cat: torch.Tensor, n: int, descending: bool) -> torch.Tensor:
    """(B, S*n) shard ids (-1 = none) -> the first n in doc-id order,
    -1 padded."""
    if descending:
        vals = torch.topk(cat, n, dim=1).values
        return torch.where(vals >= 0, vals, -1)
    keys = torch.where(cat >= 0, -cat, _KEY_FLOOR)
    vals = torch.topk(keys, n, dim=1).values
    return torch.where(vals > _KEY_FLOOR, -vals, -1)


def merge_scored(ids: torch.Tensor, scores: torch.Tensor, n: int):
    """(B, S*n) ids and float32 scores -> the first n by score
    descending, then id descending; ids of non-finite scores become -1."""
    ids, sc = sort_by_score(ids, scores)
    ids, sc = ids[:, :n], sc[:, :n]
    return torch.where(torch.isfinite(sc), ids, -1), sc


def _stack_home(parts: Sequence[torch.Tensor],
                home: torch.device) -> torch.Tensor:
    """Shards' (B, k) results -> (B, S, k) on home (peer copies)."""
    return torch.stack([p.to(home, non_blocking=True) for p in parts], 1)


def merge_topn(outs: Sequence[torch.Tensor], n: int, descending: bool,
               shard_docs: int, home: torch.device) -> torch.Tensor:
    """Shards' (B, 1 + n) ``[count | local ids]`` -> (B, 1 + n) on home."""
    both = _stack_home(outs, home)
    count = both[:, :, 0].sum(dim=1, dtype=torch.int32)
    top = merge_ids(_global_ids(both[:, :, 1:], shard_docs), n, descending)
    return torch.cat([count[:, None], top], dim=1)


def concat_words(words: Sequence[torch.Tensor],
                 home: torch.device) -> torch.Tensor:
    """Shards' (..., W / S) words -> (..., W) on home, in shard order."""
    return torch.cat([w.to(home, non_blocking=True) for w in words], dim=-1)


def to_u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# Dense programs (K1 per shard)
# ---------------------------------------------------------------------------

def _dense_shards(devices, bitmaps: ShardedTensor, deleted: ShardedTensor,
                  rows: np.ndarray, nrows: Optional[np.ndarray], extra,
                  n: int, descending: bool, words: bool = False):
    """K1 once a shard: rows (B, K) AND'ed, NOT rows (B, Kn) or None
    removed, filter rows ``extra`` (F, W) on the home device or None
    AND'ed, tombstones cleared -> each shard's ``dense_and_topn``."""
    S = len(devices)
    rows_u, nrows_u = _Uploads(rows), _Uploads(nrows)
    out = []
    for s, dev in enumerate(devices):
        with runtime.on_shard(s):
            out.append(dense_and_topn(
                bitmaps.parts[s], rows_u.to(dev), nrows_u.to(dev),
                shard_part(extra, s, S, dev), deleted.parts[s], n,
                descending, words=words))
    return out


def dense_topn(devices, bitmaps: ShardedTensor, deleted: ShardedTensor,
               rows: np.ndarray, nrows: Optional[np.ndarray], extra,
               n: int, descending: bool, shard_docs: int) -> np.ndarray:
    """The dense AND's count and first n ids, merged -> host (B, 1 + n)
    int32 ``[count | ids]``."""
    outs = [o for o, _ in _dense_shards(devices, bitmaps, deleted, rows,
                                        nrows, extra, n, descending)]
    return merge_topn(outs, n, descending, shard_docs,
                      devices[0]).cpu().numpy()


def dense_words(devices, bitmaps: ShardedTensor, deleted: ShardedTensor,
                rows: np.ndarray, nrows: Optional[np.ndarray], extra):
    """The dense AND's result words -> host (count (B,) int32, words
    (B, W) uint32)."""
    shards = _dense_shards(devices, bitmaps, deleted, rows, nrows, extra, 0,
                           False, words=True)
    home = devices[0]
    count = sum(o[:, 0].to(home, non_blocking=True) for o, _ in shards)
    host = torch.cat([count[:, None], concat_words([w for _, w in shards],
                                                   home)], 1).cpu().numpy()
    return host[:, 0], host[:, 1:].view(np.uint32)


def sharded_query_step(mesh: Mesh, n: int = 128, descending: bool = True,
                       shard_words: int = 0):
    """The batched multi-device query step:
    fn(bitmaps, rows (B, K), deleted) -> host (counts (B,), ids (B, n)),
    bitmaps and deleted as ``shard_index_arrays`` returns them (one
    ShardedTensor a dp row). The batch splits over the dp rows (B a
    multiple of dp); each row's shards run K1, and its ids merge."""
    def step(bitmaps, rows, deleted):
        rows = np.asarray(rows, dtype=np.int32)
        dp = mesh.shape["dp"]
        assert rows.shape[0] % dp == 0, "the batch must split over dp"
        b = rows.shape[0] // dp
        outs = [dense_topn(mesh.devices[r], bitmaps[r], deleted[r],
                           rows[r * b:(r + 1) * b], None, None, n,
                           descending, shard_words * 32)
                for r in range(dp)]
        out = np.concatenate(outs, axis=0)
        return out[:, 0], out[:, 1:]
    return step


# ---------------------------------------------------------------------------
# Sparse program (K3's probe entry per shard)
# ---------------------------------------------------------------------------

def sharded_sparse_query(mesh: Mesh, post_sh: ShardedTensor,
                         bitmaps: ShardedTensor, deleted: ShardedTensor,
                         d_off, d_len, sp_off, sp_len, sp_inv, dn_rows,
                         dn_inv, *, C: int, Cmax: int, limit_b: int,
                         descending: bool, shard_docs: int,
                         words_local: int, extra=None,
                         probe_free: bool = False) -> np.ndarray:
    """Batched sparse candidate-probe over the doc-sharded CSR: one K3
    probe launch a shard (top-n form), then the merge.

    Per-query driver and probe slices are PER SHARD: d_off/d_len (B, S);
    sp_off/sp_len/sp_inv (B, Ks, S) (shard-local offsets into each
    shard's CSR); dn_rows/dn_inv (B, Kd) are shared. ``extra`` (F, W) on
    the home device (or a ShardedTensor) filters on every shard.
    ``probe_free`` is the covered-exact form (nothing to probe), as the
    single-device batcher takes it. -> host (B, 1 + limit_b) int32
    ``[count | first limit_b ids]``."""
    devices = mesh.docs_devices
    S = len(devices)
    d_off, d_len = np.asarray(d_off), np.asarray(d_len)
    sp_off, sp_len = np.asarray(sp_off), np.asarray(sp_len)
    sp_inv = np.asarray(sp_inv)
    dn_rows, dn_inv = np.asarray(dn_rows), np.asarray(dn_inv)
    Ks, Kd = sp_off.shape[1], dn_rows.shape[1]
    outs = []
    for s, dev in enumerate(devices):
        args = runtime.to_device(pack_sparse_args(
            d_off[:, s], d_len[:, s], sp_off[:, :, s], sp_len[:, :, s],
            sp_inv[:, :, s], dn_rows, dn_inv), dev)
        with runtime.on_shard(s):
            outs.append(sparse_probe(
                post_sh.parts[s], bitmaps.parts[s], deleted.parts[s],
                shard_part(extra, s, S, dev), args, Ks=Ks, Kd=Kd, C=C,
                Cmax=Cmax, n_words=words_local, form="topn", width=limit_b,
                descending=descending, sparse_probes=not probe_free,
                dense_probes=not probe_free))
    return merge_topn(outs, limit_b, descending, shard_docs,
                      devices[0]).cpu().numpy()


# ---------------------------------------------------------------------------
# Word programs: boolean trees (K2's tree entry) and unions (K2's OR)
# ---------------------------------------------------------------------------

def sharded_ast_words(mesh: Mesh, post_sh: ShardedTensor,
                      bitmaps: ShardedTensor, deleted: ShardedTensor,
                      universe, rows, offs, lens, real, *, sig: tuple,
                      bucket: int, words_local: int) -> np.ndarray:
    """Boolean-tree word algebra over the doc-sharded index, no collective:
    each shard runs K2's tree program over its bitmap block and its CSR
    (leaf slices scattered as shard-local ids into local words).

    rows (T, K) shared dense leaf rows; offs/lens (T, Sl, S) per-shard
    sparse slices; real (T, Sl) marks slots holding a real term, whose
    shard-empty slice gives zeros, not the padding identity. universe: the
    all-live words (a ShardedTensor or a (W,) tensor). -> host (W,) uint32
    words, the shards' words in shard order."""
    devices = mesh.docs_devices
    S = len(devices)
    offs, lens = np.asarray(offs), np.asarray(lens)
    words = []
    for s, dev in enumerate(devices):
        with runtime.on_shard(s):
            words.append(ast_words(
                sig, bitmaps.parts[s], post_sh.parts[s], deleted.parts[s],
                shard_part(universe, s, S, dev), rows, offs[:, :, s],
                lens[:, :, s], bucket=bucket, n_words=words_local,
                real=real))
    return to_u32(concat_words(words, devices[0]))


def sharded_or_rows(mesh: Mesh, bitmaps: ShardedTensor,
                    rows: np.ndarray) -> np.ndarray:
    """OR of bitmap rows (B, K), K2 a shard -> host (B, W) uint32."""
    devices = mesh.docs_devices
    rows_u = _Uploads(rows)
    words = []
    for s, dev in enumerate(devices):
        with runtime.on_shard(s):
            words.append(reduce_rows(bitmaps.parts[s], rows_u.to(dev),
                                     "or"))
    return to_u32(concat_words(words, devices[0]))


# ---------------------------------------------------------------------------
# Fused verified search (K3 or K1, then K6 over the shard's own text rows)
# ---------------------------------------------------------------------------

def _merge_fused(parts, *, width: int, n: int, descending: bool,
                 score_mode: bool, shard_docs: int,
                 home: torch.device) -> np.ndarray:
    """Shards' (pre, count, local ids, scores or None) -> host (B, 3 + n)
    int32 ``[pre | clipped | count | ids]``, plus n float32 scores as
    their int32 bits in score mode; clipped counts the shards whose
    survivors passed ``width``."""
    # one (B, S, 2 + n [+ n]) stack: pre, count, local ids (, scores)
    both = _stack_home([torch.cat(
        [pre[:, None], count[:, None], ids.to(torch.int32)]
        + ([sc.contiguous().view(torch.int32)] if score_mode else []), 1)
        for pre, count, ids, sc in parts], home)
    pre = both[:, :, 0]
    head = [pre.sum(1, dtype=torch.int32)[:, None],
            (pre > width).sum(1, dtype=torch.int32)[:, None],
            both[:, :, 1].sum(1, dtype=torch.int32)[:, None]]
    w = parts[0][2].shape[1]
    cat = _global_ids(both[:, :, 2:2 + w], shard_docs)
    if score_mode:
        sc = both[:, :, 2 + w:].contiguous().view(torch.float32).reshape(
            cat.shape)
        top, sc = merge_scored(cat, sc, n)
        cols = head + [top, sc.contiguous().view(torch.int32)]
    else:
        cols = head + [merge_ids(cat, n, descending)]
    return torch.cat(cols, dim=1).cpu().numpy()


def split_fused(out: np.ndarray, n: int, score_mode: bool):
    """``_merge_fused``'s host matrix -> (pre, clipped, count, ids,
    scores or None)."""
    scores = (out[:, 3 + n:3 + 2 * n].copy().view(np.float32)
              if score_mode else None)
    return out[:, 0], out[:, 1], out[:, 2], out[:, 3:3 + n], scores


def _needles_on(store, needles, needle_lens, idf, cap):
    """device -> the needle tensors there, uploaded once a device."""
    cache = {}

    def on(dev):
        if dev not in cache:
            cache[dev] = _needle_tensors(store, needles, needle_lens, idf,
                                         cap, dev)
        return cache[dev]
    return on


def sharded_fused_verify(mesh: Mesh, post_sh: ShardedTensor,
                         bitmaps: ShardedTensor, deleted: ShardedTensor,
                         text_store, d_off, d_len, sp_off, sp_len, sp_inv,
                         needles, needle_lens, extra=None, *, C: int,
                         Cmax: int, Kv: int, n: int, maxT: int,
                         descending: bool, shard_docs: int,
                         words_local: int, score_mode: bool = False,
                         require_match: bool = True, idf=None,
                         k1: float = 1.2, b: float = 0.75,
                         avgdl: float = 1.0, dn_rows=None,
                         nonoverlap: bool = False) -> np.ndarray:
    """Batched fused verified search over the doc-sharded CSR and text:
    per shard, K3's probe entry compacts the driver's local candidates
    (probed by the other sparse grams where C > Kv; probe-free and masked
    where C <= Kv, the window verify subsuming every gram; where the
    verify does not filter, probed by every sparse gram and the dense
    rows ``dn_rows``), K6 windows them over the shard's own padded rows,
    the tail counts or scores them with the replicated idf and avgdl, and
    the shards merge: only n ids (and scores) a shard meet on the home
    device.

    d_off/d_len (B, S); sp_off/sp_len/sp_inv (B, Ks, S); dn_rows (B, Kd)
    dense rows, padded with the all-ones row (probed only where
    require_match is off); needles (B, Nn, CAP) uint32; extra (F, W)
    filter rows or None; idf (B, Nn).
    -> host (B, 3 + n) ``[pre | clipped | count | ids]`` (+ n score
    columns in score mode, see ``split_fused``); clipped > 0 means a
    shard's survivors passed Kv and the caller takes the exact path."""
    devices = mesh.docs_devices
    S = len(devices)
    d_off, d_len = np.asarray(d_off), np.asarray(d_len)
    sp_off, sp_len = np.asarray(sp_off), np.asarray(sp_len)
    sp_inv = np.asarray(sp_inv)
    B, Ks, Nn = d_off.shape[0], sp_off.shape[1], needles.shape[1]
    if idf is None:
        idf = np.zeros((B, Nn), dtype=np.float32)
    cap = needle_cap_bucket(max(int(np.max(needle_lens)), 1))
    use_range = _needles_need_range(text_store, needles)
    needles_on = _needles_on(text_store, needles, needle_lens, idf, cap)
    dn_rows = np.asarray(dn_rows, dtype=np.int64)
    runtime.dispatches.bump()
    parts = []
    for s, dev in enumerate(devices):
        args = runtime.to_device(pack_sparse_args(
            d_off[:, s], d_len[:, s], sp_off[:, :, s], sp_len[:, :, s],
            sp_inv[:, :, s], dn_rows, np.zeros_like(dn_rows)), dev)
        ndl, nlen, idf_t = needles_on(dev)
        with runtime.on_shard(s):
            parts.append(_sparse_search_verify_topn_batch(
                post_sh.parts[s], bitmaps.parts[s], deleted.parts[s], args,
                shard_part(extra, s, S, dev), text_store.shards[s], ndl,
                nlen, idf_t, k1, b, avgdl, Ks=Ks, Kd=dn_rows.shape[1],
                C=C, Cmax=Cmax,
                Kv=Kv, n=n, Nn=Nn, maxT=maxT, descending=descending,
                score_mode=score_mode, n_words=words_local, cap=cap,
                nonoverlap=nonoverlap, use_dense_probes=False,
                require_match=require_match, use_range=use_range))
    return _merge_fused(parts, width=Kv, n=n, descending=descending,
                        score_mode=score_mode, shard_docs=shard_docs,
                        home=devices[0])


def sharded_dense_fused_verify(mesh: Mesh, bitmaps: ShardedTensor,
                               deleted: ShardedTensor, text_store,
                               rows: np.ndarray, needles, needle_lens,
                               extra=None, *, C: int, n: int, maxT: int,
                               descending: bool, shard_docs: int,
                               score_mode: bool = False,
                               require_match: bool = True, idf=None,
                               k1: float = 1.2, b: float = 0.75,
                               avgdl: float = 1.0,
                               nonoverlap: bool = False) -> np.ndarray:
    """Batched dense-driver fused verified search, a shard at a time: K1
    AND's the rows (B, K) over the shard's bitmap block (filter rows and
    tombstones folded in) and takes its first C ids ascending, K6 windows
    them over the shard's rows, then the tail and the merge. -> as
    ``sharded_fused_verify``; clipped counts the shards with more than C
    AND matches."""
    devices = mesh.docs_devices
    S = len(devices)
    B, Nn = rows.shape[0], needles.shape[1]
    if idf is None:
        idf = np.zeros((B, Nn), dtype=np.float32)
    cap = needle_cap_bucket(max(int(np.max(needle_lens)), 1))
    use_range = _needles_need_range(text_store, needles)
    needles_on = _needles_on(text_store, needles, needle_lens, idf, cap)
    rows_u = _Uploads(rows)
    runtime.dispatches.bump()
    parts = []
    for s, dev in enumerate(devices):
        ndl, nlen, idf_t = needles_on(dev)
        with runtime.on_shard(s):
            parts.append(_search_verify_topn_batch(
                bitmaps.parts[s], rows_u.to(dev), deleted.parts[s],
                shard_part(extra, s, S, dev), text_store.shards[s], ndl,
                nlen, idf_t, k1, b, avgdl, C=C, Kv=C, n=n, Nn=Nn,
                maxT=maxT, descending=descending, score_mode=score_mode,
                cap=cap, nonoverlap=nonoverlap,
                require_match=require_match, use_range=use_range))
    return _merge_fused(parts, width=C, n=n, descending=descending,
                        score_mode=score_mode, shard_docs=shard_docs,
                        home=devices[0])


# ---------------------------------------------------------------------------
# Index mutation and the engine
# ---------------------------------------------------------------------------

def sharded_update_step(mesh: Mesh, shard_words: int):
    """The multi-device delta-apply step:
    fn(bitmaps, term_rows (U,), doc_ids (U,)) -> bitmaps, set in place.
    Each shard sets only the bits of its own doc range (pad entries with
    doc_id = -1): torch index ops on the shard's device, repeated pairs
    harmless (each word's new bits are OR'ed once)."""
    span = shard_words * 32

    def step(bitmaps, term_rows, doc_ids):
        for r, row in enumerate(mesh.devices):
            for s, dev in enumerate(row):
                bm = bitmaps[r].parts[s]
                tr = torch.as_tensor(np.asarray(term_rows, dtype=np.int64),
                                     device=dev)
                di = torch.as_tensor(np.asarray(doc_ids, dtype=np.int64),
                                     device=dev)
                local = di - s * span
                ok = (di >= 0) & (local >= 0) & (local < span)
                bits = torch.unique((tr * span + local)[ok])
                if bits.numel() == 0:
                    continue
                row_, loc = bits // span, bits % span
                word = row_ * shard_words + (loc >> 5)
                words, inv = torch.unique(word, return_inverse=True)
                # distinct bits of a word: their sum is their OR
                acc = torch.zeros(words.shape, dtype=torch.int32,
                                  device=dev)
                acc.scatter_add_(0, inv, (torch.ones_like(loc) << (loc & 31)
                                          ).to(torch.int32))
                flat = bm.view(-1)
                flat[words] = flat[words] | acc
        return bitmaps
    return step


class ShardedQueryEngine:
    """Sharded arrays and the steps over them (the JAX package's
    convenience wrapper)."""

    def __init__(self, mesh: Mesh, bitmaps: np.ndarray, deleted: np.ndarray,
                 topk: int = 128):
        self.mesh = mesh
        n_docs_shards = mesh.shape["docs"]
        V, W = bitmaps.shape
        assert W % n_docs_shards == 0, \
            f"bitmap width {W} not divisible by docs axis {n_docs_shards}"
        self.shard_words = W // n_docs_shards
        self.bitmaps, self.deleted = shard_index_arrays(mesh, bitmaps,
                                                        deleted)
        self.query = sharded_query_step(mesh, n=topk,
                                        shard_words=self.shard_words)
        self.update = sharded_update_step(mesh, self.shard_words)

    def search(self, rows: np.ndarray):
        return self.query(self.bitmaps, rows, self.deleted)

    def apply_delta(self, term_rows: np.ndarray, doc_ids: np.ndarray) -> None:
        self.bitmaps = self.update(self.bitmaps, term_rows, doc_ids)
