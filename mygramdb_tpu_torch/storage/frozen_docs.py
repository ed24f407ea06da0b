"""Columnar frozen base segment for bulk-loaded documents.

The reference keeps four hash maps per table (document_store.h:108) — fine
for C++ at ~100 bytes/doc, but the Python dict equivalent costs ~5 GB per
million documents (measured in BENCH_4M.json host_rss_mb: interned PK
strings twice, per-doc dict entries, per-doc str objects for texts). Bulk
loads instead build this immutable columnar segment:

- PKs: one int64 array when every PK is a decimal integer (the
  auto-increment common case — 8 bytes/doc), else a utf-8 blob + offsets.
- normalized texts: one utf-8 blob + int64 offsets (+ int32 codepoint
  lengths so the device text pack never re-measures).

Doc ids in the segment are contiguous ``1..n`` in insertion order (the
DocumentStore allocates monotonically from 1, document_store.h:436), so
doc -> column row is pure arithmetic. PK -> doc uses searchsorted over a
sort permutation (no per-key dict). Post-freeze mutations live in the
DocumentStore's dict overlay and shadow the segment.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np


class FrozenDocBuilder:
    """Accumulates (pk, normalized_text) rows in chunked buffers; build()
    emits a FrozenDocs. Appending never touches Python dicts — peak host
    memory during a bulk load is the blobs themselves."""

    def __init__(self, store_texts: bool = True):
        self.store_texts = store_texts
        self._pk_chunks: List[bytes] = []
        self._pk_lens: List[np.ndarray] = []
        self._txt_chunks: List[bytes] = []
        self._txt_lens: List[np.ndarray] = []   # utf-8 byte lengths
        self._cp_lens: List[np.ndarray] = []    # codepoint lengths
        self.n = 0

    def append(self, pks: Sequence[str], texts: Sequence[str]) -> None:
        """Rows for doc ids n+1 .. n+len(pks), in order."""
        if not pks:
            return
        self._pk_chunks.append("\x00".join(pks).encode("utf-8"))
        self._pk_lens.append(np.asarray(
            [len(p.encode("utf-8")) for p in pks], dtype=np.int64))
        if self.store_texts:
            self._txt_chunks.append("".join(texts).encode("utf-8"))
            self._txt_lens.append(np.asarray(
                [len(t.encode("utf-8")) for t in texts], dtype=np.int64))
            self._cp_lens.append(np.asarray(
                [len(t) for t in texts], dtype=np.int32))
        self.n += len(pks)

    def build(self) -> "FrozenDocs":
        pk_lens = (np.concatenate(self._pk_lens) if self._pk_lens
                   else np.zeros(0, dtype=np.int64))
        # strip the "\x00" joiners while concatenating chunks
        pk_blob_parts = []
        for chunk, lens in zip(self._pk_chunks, self._pk_lens):
            arr = np.frombuffer(chunk, dtype=np.uint8)
            if lens.size > 1:
                # drop separator bytes at positions cumsum(lens[:-1])+i
                seps = np.cumsum(lens[:-1]) + np.arange(lens.size - 1)
                arr = np.delete(arr, seps)
            pk_blob_parts.append(arr)
        pk_blob = (np.concatenate(pk_blob_parts) if pk_blob_parts
                   else np.zeros(0, dtype=np.uint8))
        pk_off = np.zeros(pk_lens.size + 1, dtype=np.int64)
        np.cumsum(pk_lens, out=pk_off[1:])

        if self.store_texts:
            txt_lens = (np.concatenate(self._txt_lens) if self._txt_lens
                        else np.zeros(0, dtype=np.int64))
            # preallocate the blob and consume chunks as they copy: the
            # join+frombuffer+copy form held 3x the corpus bytes at peak
            # (chunks + joined bytes + copy) — the text blob is the
            # docstore's dominant allocation at 1M+ docs
            total_b = int(txt_lens.sum())
            txt_blob = np.empty(total_b, dtype=np.uint8)
            pos = 0
            while self._txt_chunks:
                chunk = np.frombuffer(self._txt_chunks.pop(0),
                                      dtype=np.uint8)
                txt_blob[pos:pos + chunk.size] = chunk
                pos += chunk.size
                del chunk
            txt_off = np.zeros(txt_lens.size + 1, dtype=np.int64)
            np.cumsum(txt_lens, out=txt_off[1:])
            cp_lens = (np.concatenate(self._cp_lens) if self._cp_lens
                       else np.zeros(0, dtype=np.int32))
        else:
            txt_blob = None
            txt_off = None
            cp_lens = None
        self._pk_chunks = []
        self._pk_lens = []
        self._txt_chunks = []
        self._txt_lens = []
        self._cp_lens = []
        return FrozenDocs(self.n, pk_blob, pk_off, txt_blob, txt_off,
                          cp_lens)


class FrozenDocs:
    """Immutable columnar rows for doc ids 1..n (row i = doc i+1)."""

    __slots__ = ("n", "pk_blob", "pk_off", "txt_blob", "txt_off",
                 "cp_lens", "pk_num", "_pk_sorted", "_pk_perm",
                 "_pk_str_cache")

    def __init__(self, n: int, pk_blob, pk_off, txt_blob, txt_off, cp_lens):
        self.n = n
        self.pk_blob = pk_blob
        self.pk_off = pk_off
        self.txt_blob = txt_blob
        self.txt_off = txt_off
        self.cp_lens = cp_lens
        # numeric fast path: every PK a decimal int => int64 column +
        # searchsorted lookups, no string objects at all
        self.pk_num: Optional[np.ndarray] = self._try_numeric()
        self._pk_sorted = None
        self._pk_perm = None
        self._pk_str_cache: Optional[dict] = None

    # ------------------------------------------------------------------
    def _try_numeric(self) -> Optional[np.ndarray]:
        if self.n == 0:
            return None
        blob = self.pk_blob
        off = self.pk_off
        lens = np.diff(off)
        if lens.min() == 0 or lens.max() > 18:
            return None
        digits = (blob >= ord("0")) & (blob <= ord("9"))
        if not digits.all():
            return None
        # "01" != "1": leading zeros wouldn't round-trip through int
        first = blob[off[:-1]]
        if bool(((lens > 1) & (first == ord("0"))).any()):
            return None
        # vectorized decimal parse, chunked so the digit matrix stays small:
        # pad each PK into a width-wide digit row (right-aligned) and dot
        # with powers of ten
        width = int(lens.max())
        pows = (10 ** np.arange(width - 1, -1, -1)).astype(np.int64)
        pos = np.arange(width, dtype=np.int64)[None, :]
        out = np.empty(self.n, dtype=np.int64)
        step = 1 << 20
        for s in range(0, self.n, step):
            e = min(s + step, self.n)
            start = off[s:e][:, None]
            pad = width - lens[s:e][:, None]
            idx = start + pos - pad
            valid = pos >= pad
            vals = np.where(valid,
                            blob[np.clip(idx, 0, blob.size - 1)] - 48, 0)
            out[s:e] = vals.astype(np.int64) @ pows
        return out

    # ------------------------------------------------------------------
    def pk(self, doc_id: int) -> Optional[str]:
        if not (1 <= doc_id <= self.n):
            return None
        if self.pk_num is not None:
            return str(int(self.pk_num[doc_id - 1]))
        o0, o1 = int(self.pk_off[doc_id - 1]), int(self.pk_off[doc_id])
        return self.pk_blob[o0:o1].tobytes().decode("utf-8")

    def _ensure_pk_index(self) -> None:
        if self._pk_sorted is not None:
            return
        if self.pk_num is not None:
            self._pk_perm = np.argsort(self.pk_num, kind="stable")
            self._pk_sorted = self.pk_num[self._pk_perm]
        else:
            # string PKs: one dict build (str PKs are the uncommon case at
            # bulk scale; numeric PKs never pay this)
            self._pk_str_cache = {
                self.pk(d): d for d in range(1, self.n + 1)}
            self._pk_sorted = ()

    def doc_of(self, pk: str) -> Optional[int]:
        if self.n == 0:
            return None
        self._ensure_pk_index()
        if self.pk_num is not None:
            try:
                v = int(pk)
            except ValueError:
                return None
            if str(v) != pk:
                return None
            i = int(np.searchsorted(self._pk_sorted, v))
            if i < self.n and int(self._pk_sorted[i]) == v:
                return int(self._pk_perm[i]) + 1
            return None
        return self._pk_str_cache.get(pk)

    # ------------------------------------------------------------------
    def text(self, doc_id: int) -> Optional[str]:
        if self.txt_blob is None or not (1 <= doc_id <= self.n):
            return None
        o0 = int(self.txt_off[doc_id - 1])
        o1 = int(self.txt_off[doc_id])
        return self.txt_blob[o0:o1].tobytes().decode("utf-8")

    def text_cp_len(self, doc_id: int) -> int:
        if self.cp_lens is None or not (1 <= doc_id <= self.n):
            return 0
        return int(self.cp_lens[doc_id - 1])

    # ------------------------------------------------------------------
    def iter_text_codepoints(self, chunk_docs: int = 65536
                             ) -> Iterable[Tuple[int, np.ndarray,
                                                 np.ndarray]]:
        """Yield (first_doc_id, flat uint32 codepoints, cp lengths) in
        chunks — the DeviceTextStore pack path, without ever materializing
        per-doc Python strings for the whole corpus."""
        if self.txt_blob is None:
            return
        for s in range(0, self.n, chunk_docs):
            e = min(s + chunk_docs, self.n)
            b0 = int(self.txt_off[s])
            b1 = int(self.txt_off[e])
            text = self.txt_blob[b0:b1].tobytes().decode("utf-8")
            flat = np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32)
            yield s + 1, flat, self.cp_lens[s:e].astype(np.int64)

    # ------------------------------------------------------------------
    def memory_usage(self) -> int:
        total = self.pk_off.nbytes
        total += (self.pk_num.nbytes if self.pk_num is not None
                  else self.pk_blob.nbytes)
        if self.txt_blob is not None:
            total += self.txt_blob.nbytes + self.txt_off.nbytes + \
                self.cp_lens.nbytes
        if self._pk_perm is not None:
            total += self._pk_perm.nbytes * 2
        return int(total)
