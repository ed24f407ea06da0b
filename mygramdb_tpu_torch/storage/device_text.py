"""Device-resident normalized text store for verify_text and BM25 (port of
``mygramdb_tpu.storage.device_text``).

The corpus's normalized texts are packed at compaction time into one flat
code-point pack (u16 when every packed code point is below 0xFFFF, else
u32), and, when it fits the budget below, expanded on the device into a
padded ``(capacity, maxT + NEEDLE_CAP)`` matrix whose cells past a
document's end hold the sentinel. ``verify``, ``contains_masks``,
``count_tf`` and ``score_topk`` compute their term frequencies through the
window-TF kernel family (``ops.verify_ops``), with host fallback for
documents past the length cap, non-BMP documents, documents changed since
the pack (``dirty``) and needles longer than the kernel cap.

Offsets are one int64 tensor and the flat pack carries no pad tail: the
kernels mask their loads by document length and pack end, so neither a
2^31-cell limit nor a TPU tiling rule shapes the layout.

Documents the store does not pack (longer than ``maxT``, non-BMP, past the
rows) are its overflow: length 0 on the device, ``overflow_ids`` on the
host, and, where there are any, one device word row ``packed_row`` (a bit
a row, clear for an overflow document) that the fused verified program
takes as a filter row, so that it answers over the packed documents and
the caller verifies and scores the overflow ones on the host
(``overflow_tf``, in their code points packed once on the host at the
build).

On a doc-sharded index (``doc_sharding``, the index's mesh) the padded
matrix is built doc-sharded whenever the padded layout is taken: shard s
holds rows ``[s * Ds, (s + 1) * Ds)`` and their lengths on its own device
(``shards``), built there from its part of the flat pack, so the mesh's
fused verify windows each shard's candidates where they are and the exact
path's calls go to the shard that holds each candidate. The flat layout
stays whole on the mesh's home device.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import runtime
from ..ops.verify_ops import (NEEDLE_CAP, bm25_topk_device,
                              count_occurrences_device, has_self_overlap,
                              needle_cap_bucket, substring_masks_device,
                              substring_verify_device)
from .. import native

# candidates per device call (bounds the plain versions' CPU workspace)
_C_CHUNK = 65536
# Padded layout budget on an 80 GB H100: half the card. The other half
# holds, while the matrix is built, the flat pack it is built from (never
# larger than the matrix: maxT covers the p99 length), the index (0.22 GB
# per 1M documents, measured at 1.1M) and the batches' working tensors.
# At 1.1M documents and maxT 512 the matrix takes 1.2 GB.
_PADDED_BUDGET_BYTES = 40 << 30
_MAXT_CHOICES = (256, 512, 1024, 2048, 4096)
_U16_MAX = 0xFFFF  # BMP ceiling; docs with any cp >= this stay uint32/host
# rows of the padded matrix built per step (bounds the int64 index tile)
_PAD_BLOCK_CELLS = 32 << 20


def _pad_on_device(flat: torch.Tensor, offsets: torch.Tensor,
                   lengths: torch.Tensor, rowT: int,
                   sentinel: int) -> torch.Tensor:
    """(P,) flat pack -> (rows, rowT) padded matrix, sentinel past each
    document's length, built block by block on the pack's device."""
    rows = offsets.shape[0]
    out = torch.full((rows, rowT), sentinel, dtype=flat.dtype,
                     device=flat.device)
    pos = torch.arange(rowT, dtype=torch.int64, device=flat.device)
    block = max(1, _PAD_BLOCK_CELLS // rowT)
    for r0 in range(0, rows, block):
        off = offsets[r0:r0 + block, None]
        valid = pos[None, :] < lengths[r0:r0 + block, None].to(torch.int64)
        idx = torch.where(valid, off + pos[None, :], 0)
        out[r0:r0 + block] = torch.where(valid, flat[idx], sentinel)
    return out


def host_bm25(tf: np.ndarray, dl: np.ndarray, idf: np.ndarray, k1: float,
              b: float, avgdl: float) -> np.ndarray:
    """(n,) float64 BM25 of the host fallback from tf (n, Nn), doc
    lengths dl (n,) and idf (Nn,) (reference bm25_scorer.h:41, as
    ``ops.verify_ops.bm25_scores`` on the device)."""
    tff = tf.astype(np.float64)
    norm = k1 * (1.0 - b + b * dl.astype(np.float64)[:, None] /
                 max(avgdl, 1e-9))
    return np.sum(np.asarray(idf, dtype=np.float64)[None, :] * tff
                  * (k1 + 1.0) / np.maximum(tff + norm, 1e-9), axis=1)


class TextShard:
    """Rows ``[lo, lo + rows)`` of a doc-sharded padded matrix on one
    device: what ``ops.fused`` and the exact path read of a store
    (``codepoints`` (rows, rowT), ``lengths`` (rows,), no offsets)."""

    def __init__(self, codepoints: torch.Tensor, lengths: torch.Tensor,
                 lo: int, dtype, maxT: int, shard: int):
        self.codepoints = codepoints
        self.lengths = lengths
        self.offsets = None
        self.lo = lo
        self.shard = shard
        self.dtype = dtype
        self.maxT = maxT
        self._device = codepoints.device


class DeviceTextStore:
    lo = 0  # the doc id of row 0 (a TextShard's first row is not 0)
    shard = None  # a TextShard's index on the mesh
    doc_sharded = False
    shards: List[TextShard] = []

    def __init__(self, texts_by_doc: Dict[int, str], capacity: int,
                 device=None, doc_sharding=None):
        """texts_by_doc: doc id -> normalized text (snapshot at build).
        doc_sharding: the index's mesh, or None."""
        self._doc_sharding = doc_sharding
        ids_arr = np.asarray(list(texts_by_doc.keys()), dtype=np.int64)
        lens_arr = np.asarray([len(t) for t in texts_by_doc.values()],
                              dtype=np.int64)
        # one encode over the whole corpus
        flat = np.frombuffer(
            "".join(texts_by_doc.values()).encode("utf-32-le"),
            dtype=np.uint32).copy()
        self._build(ids_arr, lens_arr, flat, capacity, device)
        self._pack_overflow(lambda ids: [texts_by_doc.get(d) for d in ids])

    @classmethod
    def from_doc_store(cls, doc_store, capacity: int, device=None,
                       doc_sharding=None) -> "DeviceTextStore":
        """Build from a hybrid DocumentStore. The frozen columnar base
        streams straight from its utf-8 blob; post-freeze overlay texts
        append after, shadowing their frozen rows. doc_sharding: the
        index's mesh (the padded rows shard with the index), or None."""
        frozen = getattr(doc_store, "frozen", None)
        if frozen is None or frozen.txt_blob is None:
            return cls(doc_store.texts_snapshot(), capacity, device,
                       doc_sharding)
        overlay = doc_store.text_overlay()
        fast = cls._from_frozen_native(frozen, overlay, capacity, device,
                                       doc_sharding)
        if fast is not None:
            fast._pack_overflow(doc_store.texts_batch)
            return fast
        ov_ids = np.asarray(list(overlay.keys()), dtype=np.int64)
        id_parts: List[np.ndarray] = []
        len_parts: List[np.ndarray] = []
        flat_parts: List[np.ndarray] = []
        for first, flat, lens in frozen.iter_text_codepoints():
            ids = np.arange(first, first + lens.size, dtype=np.int64)
            if ov_ids.size:
                keep = ~np.isin(ids, ov_ids)
                if not keep.all():
                    flat = flat[np.repeat(keep, lens)]
                    ids = ids[keep]
                    lens = lens[keep]
            id_parts.append(ids)
            len_parts.append(lens)
            flat_parts.append(flat)
        if overlay:
            texts = list(overlay.values())
            id_parts.append(ov_ids)
            len_parts.append(np.asarray([len(t) for t in texts],
                                        dtype=np.int64))
            flat_parts.append(np.frombuffer(
                "".join(texts).encode("utf-32-le"), dtype=np.uint32))
        obj = cls.__new__(cls)
        obj._doc_sharding = doc_sharding
        obj._build(
            np.concatenate(id_parts) if id_parts else
            np.zeros(0, dtype=np.int64),
            np.concatenate(len_parts) if len_parts else
            np.zeros(0, dtype=np.int64),
            np.concatenate(flat_parts) if flat_parts else
            np.zeros(0, dtype=np.uint32),
            capacity, device)
        obj._pack_overflow(doc_store.texts_batch)
        return obj

    @classmethod
    def _from_frozen_native(cls, frozen, overlay: Dict[int, str],
                            capacity: int, device, doc_sharding=None
                            ) -> Optional["DeviceTextStore"]:
        """One-pass native pack from the frozen store's UTF-8 blob:
        ``utf8_decode_u16`` writes the final u16 buffer directly; non-BMP
        and malformed documents are flagged per document and go to the
        host verify. Overlay texts (writes since the freeze) append after
        the frozen cells and shadow their rows through offsets/lengths."""
        if frozen.cp_lens is None or not native.available():
            return None
        n = frozen.n
        cp_lens = frozen.cp_lens
        cp_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(cp_lens, out=cp_off[1:])
        total = int(cp_off[-1])

        ov_ids: List[int] = []
        ov_cps: List[np.ndarray] = []
        bad_overlay: List[int] = []
        for d, t in overlay.items():
            cp = np.frombuffer(t.encode("utf-32-le"), dtype=np.uint32)
            if cp.size and int(cp.max()) >= _U16_MAX:
                bad_overlay.append(int(d))
                continue
            ov_ids.append(int(d))
            ov_cps.append(cp.astype(np.uint16))
        ov_total = sum(c.size for c in ov_cps)

        flat = np.empty(max(total + ov_total, 1), dtype=np.uint16)
        bad = native.utf8_decode_u16(frozen.txt_blob, frozen.txt_off,
                                     cp_off, flat, _U16_MAX)
        if bad is None:  # stale .so without the entry point
            return None

        obj = cls.__new__(cls)
        obj._doc_sharding = doc_sharding
        obj.capacity = capacity
        if n:
            p99 = int(np.percentile(cp_lens, 99))
            obj.maxT = next((m for m in _MAXT_CHOICES if m >= p99),
                            _MAXT_CHOICES[-1])
        else:
            obj.maxT = _MAXT_CHOICES[0]
        obj.dtype = np.uint16
        lengths = np.zeros(capacity, dtype=np.int32)
        offsets = np.zeros(capacity, dtype=np.int64)
        m = min(n, capacity - 1)  # frozen rows are doc ids 1..n
        lengths[1:m + 1] = cp_lens[:m]
        offsets[1:m + 1] = cp_off[:m]
        obj._overflow = set()
        kill = np.flatnonzero((bad[:m] != 0) | (cp_lens[:m] > obj.maxT)) + 1
        obj._overflow.update(int(d) for d in kill.tolist())
        obj._overflow.update(range(m + 1, n + 1))
        lengths[kill] = 0
        pos = total
        for d, cp in zip(ov_ids, ov_cps):
            if d < 1 or d >= capacity or cp.size > obj.maxT:
                obj._overflow.add(d)
                if 1 <= d < capacity:
                    lengths[d] = 0
                continue
            flat[pos:pos + cp.size] = cp
            offsets[d] = pos
            lengths[d] = cp.size
            obj._overflow.discard(d)
            pos += cp.size
        for d in bad_overlay:
            obj._overflow.add(d)
            if 1 <= d < capacity:
                lengths[d] = 0
        obj._upload(flat, offsets, lengths, device, _U16_MAX)
        # overlay docs shadowing a frozen row replace it, not add to it
        n_new = sum(1 for d in overlay if not (1 <= int(d) <= n))
        obj.n_packed = n + n_new - len(obj._overflow)
        return obj

    @classmethod
    def from_state(cls, state: dict, device=None) -> "DeviceTextStore":
        """Build from host arrays (for example a JAX ``DeviceTextStore``'s,
        read by ``mygramdb_tpu_torch.convert.text_state_from_jax``): the
        flat pack or the padded matrix as it is, with its offsets,
        lengths, dtype, maxT and overflow set."""
        obj = cls.__new__(cls)
        obj._doc_sharding = None
        obj.capacity = int(state["capacity"])
        obj.maxT = int(state["maxT"])
        obj.dtype = np.dtype(state["dtype"]).type
        obj._overflow = set(state["overflow"])
        obj.n_packed = int(state["n_packed"])
        cells = np.ascontiguousarray(state["codepoints"], dtype=obj.dtype)
        obj._set_host(state["offsets"], state["lengths"], device)
        obj.codepoints = runtime.to_device(obj._signed(cells), obj._device)
        return obj

    def _build(self, ids_arr: np.ndarray, lens_arr: np.ndarray,
               flat: np.ndarray, capacity: int, device) -> None:
        """Core pack from parallel (ids, lengths, flat codepoints)."""
        self.capacity = capacity
        n_total = ids_arr.size
        lengths = np.zeros(capacity, dtype=np.int32)
        offsets = np.zeros(capacity, dtype=np.int64)
        # choose maxT covering ~p99 of lengths (cap 4096)
        if lens_arr.size:
            p99 = int(np.percentile(lens_arr, 99))
            self.maxT = next((m for m in _MAXT_CHOICES if m >= p99),
                             _MAXT_CHOICES[-1])
        else:
            self.maxT = _MAXT_CHOICES[0]
        self._overflow = set()
        drop = (ids_arr >= capacity) | (lens_arr > self.maxT) | (ids_arr < 1)
        if drop.any():
            self._overflow.update(int(d) for d in ids_arr[drop].tolist())
            flat = flat[np.repeat(~drop, lens_arr)]
            ids_arr = ids_arr[~drop]
            lens_arr = lens_arr[~drop]
        starts = np.zeros(lens_arr.size, dtype=np.int64)
        if lens_arr.size:
            np.cumsum(lens_arr[:-1], out=starts[1:])
        # non-BMP docs go to the host verify so that the pack can be u16;
        # U+FFFF itself is excluded too: it is the u16 sentinel
        if flat.size and flat.max() >= _U16_MAX:
            nonzero = lens_arr > 0
            segmax = np.zeros(lens_arr.size, dtype=np.uint32)
            if nonzero.any():
                segmax[nonzero] = np.maximum.reduceat(flat,
                                                      starts[nonzero])
            bad = segmax >= _U16_MAX
            if bad.any():
                for d in ids_arr[bad].tolist():
                    self._overflow.add(int(d))
                keep_cp = np.repeat(~bad, lens_arr)
                flat = flat[keep_cp]
                ids_arr = ids_arr[~bad]
                lens_arr = lens_arr[~bad]
                starts = np.zeros(lens_arr.size, dtype=np.int64)
                if lens_arr.size:
                    np.cumsum(lens_arr[:-1], out=starts[1:])
        self.dtype = np.uint16 if (not flat.size
                                   or flat.max() < _U16_MAX) else np.uint32
        sentinel = _U16_MAX if self.dtype == np.uint16 else 0xFFFFFFFF
        flat = flat.astype(self.dtype, copy=False)
        if not flat.size:
            flat = np.zeros(1, dtype=self.dtype)
        offsets[ids_arr] = starts
        lengths[ids_arr] = lens_arr.astype(np.int32)
        self._upload(flat, offsets, lengths, device, sentinel)
        self.n_packed = int(n_total) - len(self._overflow)

    @staticmethod
    def _signed(cells: np.ndarray) -> np.ndarray:
        """u16/u32 cells -> int16/int32 with the same bits (the tensor
        types the kernels take)."""
        return cells.view(np.int16 if cells.dtype == np.uint16 else np.int32)

    def _set_host(self, offsets: np.ndarray, lengths: np.ndarray,
                  device) -> None:
        if self._doc_sharding is not None:
            self._device = self._doc_sharding.home
        else:
            self._device = (torch.device(device) if device is not None
                            else runtime.device())
        # host copies: planners bound candidate lengths without a pull
        self.lengths_host = np.asarray(lengths, dtype=np.int32)
        self.offsets_host = np.asarray(offsets, dtype=np.int64)
        self.offsets = runtime.to_device(self.offsets_host, self._device)
        self.lengths = runtime.to_device(self.lengths_host, self._device)
        self._set_overflow()

    def _set_overflow(self) -> None:
        """``overflow_ids`` (sorted, the overflow documents among the
        rows) and ``packed_row``: every bit set but those of the overflow
        documents, a (ceil(capacity / 32),) word row on the home device,
        or None when nothing overflows."""
        ov = np.asarray(sorted(d for d in self._overflow
                               if 0 < d < self.capacity), dtype=np.int64)
        self.overflow_ids = ov
        self.overflow_cells = self.overflow_offsets = None
        self.packed_row = None
        if ov.size:
            words = np.full((self.capacity + 31) // 32, 0xFFFFFFFF,
                            dtype=np.uint32)
            np.bitwise_and.at(words, ov >> 5, np.bitwise_not(np.left_shift(
                np.uint32(1), (ov & 31).astype(np.uint32))))
            self.packed_row = runtime.to_device(words, self._device)

    def _pack_overflow(self, texts_of) -> None:
        """The overflow documents' code points, packed once on the host
        (``native.pack_texts`` of ``texts_of(overflow_ids)``):
        ``overflow_cells`` and ``overflow_offsets``, in ``overflow_ids``
        order."""
        self.overflow_cells, self.overflow_offsets = native.pack_texts(
            texts_of(self.overflow_ids.tolist()))

    def overflow_tf(self, ids: np.ndarray, terms: Sequence[str]):
        """-> (tf (n, len(terms)) int32, doc lengths (n,) int32) of the
        overflow documents ``ids`` (sorted, among ``overflow_ids``): the
        terms' non-overlapping occurrences, counted on the host in the
        packed code points (a store built from texts or a document store;
        one built from host arrays, ``from_state``, holds none)."""
        pos = np.searchsorted(self.overflow_ids, ids)
        start = self.overflow_offsets[pos]
        end = self.overflow_offsets[pos + 1]
        off = np.zeros(ids.size + 1, dtype=np.int64)
        np.cumsum(end - start, out=off[1:])
        cells = np.concatenate([self.overflow_cells[a:e] for a, e in
                                zip(start.tolist(), end.tolist())])
        return native.count_occurrences_packed(cells, off, list(terms))

    @property
    def layout(self) -> str:
        """``padded`` (the matrix, whole or doc-sharded) or ``flat``."""
        return ("padded" if self.doc_sharded or self.codepoints.dim() == 2
                else "flat")

    def _upload(self, flat: np.ndarray, offsets: np.ndarray,
                lengths: np.ndarray, device, sentinel: int) -> None:
        """Ship the pack to the device: the padded (capacity, maxT +
        NEEDLE_CAP) matrix when it fits the budget (built on the device
        from the flat pack, so only the flat bytes cross the bus), else
        the flat pack. ``MYGRAM_TEXT_LAYOUT=flat|padded`` overrides the
        budget rule."""
        self._set_host(offsets, lengths, device)
        rowT = self.maxT + NEEDLE_CAP
        itemsize = np.dtype(self.dtype).itemsize
        layout = os.environ.get("MYGRAM_TEXT_LAYOUT", "auto")
        fits = self.capacity * rowT * itemsize <= _PADDED_BUDGET_BYTES
        padded = layout == "padded" or (layout != "flat" and fits)
        sent = int(np.asarray(sentinel, dtype=self.dtype).view(
            np.int16 if self.dtype == np.uint16 else np.int32))
        if padded and self._doc_sharding is not None:
            self._build_sharded(flat, rowT, sent)
            return
        flat_dev = runtime.to_device(self._signed(flat), self._device)
        if padded:
            self.codepoints = _pad_on_device(flat_dev, self.offsets,
                                             self.lengths, rowT, sent)
            del flat_dev
        else:
            self.codepoints = flat_dev

    def _build_sharded(self, flat: np.ndarray, rowT: int,
                       sent: int) -> None:
        """The doc-sharded padded matrix: shard s's rows built on its
        device from the part of the flat pack its documents occupy (one
        span: the frozen base is packed in doc-id order; an overlay
        document packed at the end widens its shard's span, never the
        answer)."""
        from ..parallel.mesh import ShardedTensor
        devices = self._doc_sharding.docs_devices
        S = len(devices)
        if self.capacity % S:
            raise ValueError(f"{S} shards do not divide {self.capacity} "
                             "rows")
        Ds = self.capacity // S
        self.shard_docs = Ds
        self.shards = []
        for s, dev in enumerate(devices):
            lens = self.lengths_host[s * Ds:(s + 1) * Ds]
            offs = self.offsets_host[s * Ds:(s + 1) * Ds]
            live = lens > 0
            a = int(offs[live].min()) if live.any() else 0
            e = int((offs[live] + lens[live]).max()) if live.any() else 1
            flat_s = runtime.to_device(self._signed(flat[a:max(e, a + 1)]),
                                       dev)
            lens_t = runtime.to_device(lens, dev)
            self.shards.append(TextShard(
                _pad_on_device(flat_s, runtime.to_device(
                    np.where(live, offs - a, 0), dev), lens_t, rowT, sent),
                lens_t, s * Ds, self.dtype, self.maxT, s))
            del flat_s
        self.codepoints = ShardedTensor([t.codepoints for t in self.shards],
                                        axis=0)
        # the whole store's lengths and offsets live on the host only
        self.offsets = None
        self.lengths = ShardedTensor([t.lengths for t in self.shards],
                                     axis=0)
        self.doc_sharded = True

    # the flat layout's window buckets (the padded layout reads whole rows
    # outside the fused path)
    _MAXT_SLICE_BUCKETS = (128, 512, 2048)

    def maxT_bucket(self, bound: int) -> int:
        """Smallest window bucket covering ``bound`` (a known upper bound
        on candidate text lengths): the window kernels pay per cell."""
        for m in self._MAXT_SLICE_BUCKETS:
            if m >= bound and m <= self.maxT:
                return m
        return self.maxT

    def _chunk_maxT(self, chunk: np.ndarray) -> int:
        if self.codepoints.dim() == 2:
            return self.maxT
        ok = (chunk >= 0) & (chunk < self.lengths_host.shape[0])
        bound = int(self.lengths_host[chunk[ok]].max()) if ok.any() else 1
        return self.maxT_bucket(max(bound, 1))

    def _device_ok(self, cand_ids: np.ndarray, dirty) -> np.ndarray:
        """Candidates whose packed text is current: in range, packed, and
        not changed since the pack."""
        return np.asarray(
            [0 < d < self.capacity and d not in self._overflow
             and d not in dirty for d in cand_ids.tolist()], dtype=bool)

    def _calls(self, ids: np.ndarray):
        """(positions in ids, those ids, their rows in the part as a
        tensor on its device, the part) per device call: the store itself,
        or on a doc-sharded store the shard holding each id (its launches
        counted for that shard while the caller runs the call)."""
        if self.doc_sharded:
            owner = ids // self.shard_docs
            groups = [(part, np.flatnonzero(owner == s))
                      for s, part in enumerate(self.shards)]
        else:
            groups = [(self, np.arange(ids.size))]
        for part, positions in groups:
            for pos in range(0, positions.size, _C_CHUNK):
                sel = positions[pos:pos + _C_CHUNK]
                chunk = ids[sel]
                runtime.dispatches.bump()
                with runtime.on_shard(part.shard):
                    yield sel, chunk, runtime.to_device(
                        (chunk - part.lo).astype(np.int32), part._device), part

    # ------------------------------------------------------------------
    def verify(self, cand_ids: np.ndarray, needles: Sequence[str],
               texts_fallback, dirty=frozenset()) -> np.ndarray:
        """-> bool mask over cand_ids (contains ALL needles).

        texts_fallback(ids) -> list[Optional[str]] serves overflow docs,
        ``dirty`` docs (mutated since the pack — their packed text is
        stale) and needles beyond the kernel cap."""
        if cand_ids.size == 0:
            return np.zeros(0, dtype=bool)
        needles = [n for n in needles if n]
        if not needles:
            return np.ones(cand_ids.size, dtype=bool)
        if any(len(n) > NEEDLE_CAP for n in needles):
            return native.substring_verify(texts_fallback(cand_ids.tolist()),
                                           list(needles))
        device_ok = self._device_ok(cand_ids, dirty)
        host_ids = cand_ids[~device_ok]
        mask = np.zeros(cand_ids.size, dtype=bool)
        if host_ids.size:
            mask[~device_ok] = native.substring_verify(
                texts_fallback(host_ids.tolist()), list(needles))
        dev_ids = cand_ids[device_ok]
        if dev_ids.size:
            runtime.count_route("verify_exact")
            ndl, nlens = self._pack_needles(needles)
            out = np.zeros(dev_ids.size, dtype=bool)
            for sel, chunk, ids_t, part in self._calls(dev_ids):
                m = substring_verify_device(
                    part.codepoints, part.offsets, part.lengths, ids_t, ndl,
                    nlens, C=chunk.size, maxT=self._chunk_maxT(chunk),
                    Nn=len(needles), cap=needle_cap_bucket(int(nlens.max())),
                    use_range=self._needles_need_range(ndl))
                out[sel] = m.cpu().numpy()
            mask[device_ok] = out
        return mask

    def _needles_need_range(self, ndl: np.ndarray) -> bool:
        """The in-range window mask is needed only when a needle code
        point clamps to the u16 padding sentinel."""
        return (self.dtype == np.uint16 and ndl.size > 0
                and int(ndl.max()) >= 0xFFFF)

    # ------------------------------------------------------------------
    def contains_masks(self, cand_ids: np.ndarray, needles: Sequence[str],
                       texts_fallback, dirty=frozenset()) -> np.ndarray:
        """-> (C, Nn) bool per-needle contains matrix (boolean-AST text
        post-filter). Host fallback per needle for overflow/dirty docs and
        over-cap needles."""
        n = cand_ids.size
        Nn = len(needles)
        out = np.zeros((n, Nn), dtype=bool)
        if n == 0 or Nn == 0:
            return out
        if any(len(nd) > NEEDLE_CAP or not nd for nd in needles):
            texts = texts_fallback(cand_ids.tolist())
            for j, nd in enumerate(needles):
                out[:, j] = native.substring_verify(texts, [nd]) if nd \
                    else True
            return out
        device_ok = self._device_ok(cand_ids, dirty)
        host_ids = cand_ids[~device_ok]
        if host_ids.size:
            texts = texts_fallback(host_ids.tolist())
            for j, nd in enumerate(needles):
                out[~device_ok, j] = native.substring_verify(texts, [nd])
        dev_ids = cand_ids[device_ok]
        if dev_ids.size:
            runtime.count_route("verify_exact")
            ndl, nlens = self._pack_needles(needles)
            dev_out = np.zeros((dev_ids.size, Nn), dtype=bool)
            for sel, chunk, ids_t, part in self._calls(dev_ids):
                m = substring_masks_device(
                    part.codepoints, part.offsets, part.lengths, ids_t, ndl,
                    nlens, C=chunk.size, maxT=self._chunk_maxT(chunk),
                    Nn=Nn, cap=needle_cap_bucket(int(nlens.max())),
                    use_range=self._needles_need_range(ndl))
                dev_out[sel] = m.cpu().numpy()
            out[device_ok] = dev_out
        return out

    # ------------------------------------------------------------------
    def count_tf(self, cand_ids: np.ndarray, terms: Sequence[str],
                 texts_fallback, dirty=frozenset()):
        """BM25 TF matrix + doc lengths; device kernel with host fallback
        (overflow/dirty docs; over-cap needles). Self-overlapping terms
        count leftmost-greedy (the reference's non-overlapping count)."""
        n = cand_ids.size
        tf = np.zeros((n, len(terms)), dtype=np.int32)
        dl = np.zeros(n, dtype=np.int32)
        if n == 0 or not terms:
            return tf, dl
        if any(len(t) > NEEDLE_CAP or len(t) == 0 for t in terms):
            return native.count_occurrences(
                texts_fallback(cand_ids.tolist()), list(terms))
        nonoverlap = any(has_self_overlap(t) for t in terms)
        device_ok = self._device_ok(cand_ids, dirty)
        host_ids = cand_ids[~device_ok]
        if host_ids.size:
            h_tf, h_dl = native.count_occurrences(
                texts_fallback(host_ids.tolist()), list(terms))
            tf[~device_ok] = h_tf
            dl[~device_ok] = h_dl
        dev_ids = cand_ids[device_ok]
        if dev_ids.size:
            runtime.count_route("verify_exact")
            ndl, nlens = self._pack_needles(terms)
            d_tf = np.zeros((dev_ids.size, len(terms)), dtype=np.int32)
            d_dl = np.zeros(dev_ids.size, dtype=np.int32)
            for sel, chunk, ids_t, part in self._calls(dev_ids):
                t_m, l_m = count_occurrences_device(
                    part.codepoints, part.offsets, part.lengths, ids_t, ndl,
                    nlens, C=chunk.size, maxT=self._chunk_maxT(chunk),
                    Nn=len(terms), cap=needle_cap_bucket(int(nlens.max())),
                    nonoverlap=nonoverlap)
                d_tf[sel] = t_m.cpu().numpy()
                d_dl[sel] = l_m.cpu().numpy()
            tf[device_ok] = d_tf
            dl[device_ok] = d_dl
        return tf, dl

    @staticmethod
    def _pack_needles(terms: Sequence[str]):
        Nn = len(terms)
        ndl = np.zeros((Nn, NEEDLE_CAP), dtype=np.uint32)
        nlens = np.zeros(Nn, dtype=np.int32)
        for i, t in enumerate(terms):
            cp = np.frombuffer(t.encode("utf-32-le"), dtype=np.uint32)
            ndl[i, :cp.size] = cp
            nlens[i] = cp.size
        return ndl, nlens

    def score_topk(self, cand_ids: np.ndarray, terms: Sequence[str],
                   idf: np.ndarray, avgdl: float, k1: float, b: float,
                   n: int, texts_fallback, dirty=frozenset()):
        """Fused BM25 TF -> score -> top-n on the device: only n (id,
        score) pairs per chunk cross to the host. Overflow / dirty docs
        score on the host and merge.

        -> (ids (<=n,) int32 score-desc (ties id-desc), scores float64),
        or None when no device path applies (the caller falls back)."""
        if cand_ids.size == 0 or not terms:
            return None
        if any(len(t) > NEEDLE_CAP or len(t) == 0 for t in terms):
            return None
        nonoverlap = any(has_self_overlap(t) for t in terms)
        device_ok = self._device_ok(cand_ids, dirty)
        pairs: List[Tuple[float, int]] = []  # (score, id)
        host_ids = cand_ids[~device_ok]
        if host_ids.size:
            h_tf, h_dl = native.count_occurrences(
                texts_fallback(host_ids.tolist()), list(terms))
            h_sc = host_bm25(h_tf, h_dl, idf, k1, b, avgdl)
            pairs.extend(zip(h_sc.tolist(), host_ids.tolist()))
        dev_ids = cand_ids[device_ok]
        if dev_ids.size:
            runtime.count_route("verify_exact")
            ndl, nlens = self._pack_needles(terms)
            for _, chunk, ids_t, part in self._calls(dev_ids):
                t_ids, t_sc = bm25_topk_device(
                    part.codepoints, part.offsets, part.lengths, ids_t, ndl,
                    nlens, idf, k1, b, avgdl, C=chunk.size,
                    maxT=self._chunk_maxT(chunk), Nn=len(terms),
                    n=min(n, chunk.size),
                    cap=needle_cap_bucket(int(nlens.max())),
                    nonoverlap=nonoverlap)
                t_ids = t_ids.cpu().numpy()
                t_sc = t_sc.cpu().numpy()
                keep = t_ids >= 0
                pairs.extend(zip(t_sc[keep].tolist(),
                                 (t_ids[keep] + part.lo).tolist()))
        pairs.sort(key=lambda p: (-p[0], -p[1]))
        pairs = pairs[:n]
        ids = np.asarray([p[1] for p in pairs], dtype=np.int32)
        scores = np.asarray([p[0] for p in pairs], dtype=np.float64)
        return ids, scores

    def memory_usage(self) -> int:
        """Device bytes: the pack or matrix, offsets, lengths and the
        overflow row (summed over the shards of a doc-sharded store)."""
        return sum(self.shard_memory())

    def shard_memory(self) -> List[int]:
        """Device bytes of each shard (one entry for a store that is not
        doc-sharded); the overflow row counts on the first, whose device
        is the home one."""
        if self.doc_sharded:
            out = [int(t.codepoints.numel() * t.codepoints.element_size()
                       + t.lengths.numel() * 4) for t in self.shards]
        else:
            out = [int(self.codepoints.numel()
                       * self.codepoints.element_size()
                       + self.offsets.numel() * 8
                       + self.lengths.numel() * 4)]
        if self.packed_row is not None:
            out[0] += int(self.packed_row.numel() * 4)
        return out
