"""Which documents hold which grams, worked out from the normalized texts
with numpy alone: the reference's postings and the traffic generator's
document frequencies.

A query gram is one or two code points, and every such string that occurs
in a document is one of the document's grams under the table's emission
rules (see ``textrules``), so a document holds a gram exactly when the gram
is a substring of its text. The documents are joined with a NUL between
them, ASCII documents as bytes and the others as code points, and every
position's one- and two-point keys are looked up in a table of the grams
asked for; the hits are grouped by gram with a radix sort.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

CHUNK = 1 << 24  # positions a pass
NONE = 0xFFFF    # "not asked for" in a gram table
BITMAP_BYTES = 1 << 30  # bitmaps a pass of the byte segment


class Corpus:
    """Normalized texts of docs 1..N (``texts[0]`` is unused)."""

    def __init__(self, texts: Sequence[str]):
        self.texts = texts
        self.n_docs = len(texts) - 1
        lens = np.fromiter((len(t) for t in texts[1:]), dtype=np.int64,
                           count=self.n_docs)
        self.doc_len = np.concatenate([[0], lens])
        ids = np.arange(1, self.n_docs + 1, dtype=np.int32)
        ascii_ = np.fromiter((t.isascii() for t in texts[1:]), dtype=bool,
                             count=self.n_docs)
        self.segments = []
        for mask, wide in ((ascii_, False), (~ascii_, True)):
            docs = ids[mask]
            if not docs.size:
                continue
            joined = "\0".join(texts[d] for d in docs.tolist())
            if wide:
                cp = np.frombuffer(joined.encode("utf-32-le"),
                                   dtype=np.uint32)
                if int(cp.max()) > 0xFFFF:
                    raise ValueError("a document holds a code point past "
                                     "the BMP")
                present = np.bincount(cp, minlength=0x10000) > 0
                lut = np.zeros(0x10000, dtype=np.int32)
                lut[present] = np.arange(1, int(present.sum()) + 1)
                sym = lut[cp]
                alpha = int(present.sum()) + 1
            else:
                sym = np.frombuffer(joined.encode("ascii"), dtype=np.uint8)
                lut, alpha = None, 256
            doc = np.repeat(docs, self.doc_len[docs] + 1)[:sym.size]
            self.segments.append({"sym": sym, "doc": doc, "lut": lut,
                                  "alpha": alpha})

    @staticmethod
    def _key(seg: dict, gram: str) -> int:
        """A gram's key in a segment: its symbol for one code point
        (below alpha), alpha + a * alpha + b for two; -1 when it cannot
        occur there."""
        cps = [ord(c) for c in gram]
        if not 1 <= len(cps) <= 2 or max(cps) > 0xFFFF:
            return -1
        if seg["lut"] is None:
            if max(cps) > 0x7F:
                return -1
            ids = cps
        else:
            ids = [int(seg["lut"][c]) for c in cps]
            if 0 in ids:
                return -1
        a = seg["alpha"]
        return ids[0] if len(ids) == 1 else a + ids[0] * a + ids[1]

    @staticmethod
    def _tables(seg: dict, keyed):
        """Lookup tables, key -> index into keyed, for the one- and the
        two-point grams (None where none is asked)."""
        a = seg["alpha"]
        uni = np.full(a, NONE, dtype=np.uint16)
        bi = np.full(a * a, NONE, dtype=np.uint16)
        for i, k in keyed:
            if k < a:
                uni[k] = i
            else:
                bi[k - a] = i
        return ((uni if (uni != NONE).any() else None),
                (bi if (bi != NONE).any() else None))

    @staticmethod
    def _chunks(seg: dict, uni, bi):
        """For each chunk of positions: (gram index of each position that
        starts an asked gram, its document)."""
        a = seg["alpha"]
        sym, doc = seg["sym"], seg["doc"]
        # the pair's index a * x + y: 16 bits for bytes, 32 for code points
        wide = np.uint16 if seg["lut"] is None else np.int32
        for s in range(0, sym.size, CHUNK):
            e = min(s + CHUNK, sym.size)
            x = sym[s:e]
            d = doc[s:e]
            if uni is not None:
                gi = uni[x]
                hit = gi != NONE
                yield gi[hit], d[hit]
            if bi is not None:
                y = sym[s + 1:e + 1]
                if y.size < x.size:  # the last position has no pair
                    y = np.concatenate([y, np.zeros(1, dtype=y.dtype)])
                gi = bi[x.astype(wide) * wide(a) + y]
                hit = gi != NONE
                yield gi[hit], d[hit]

    def _postings_bitmap(self, seg: dict, keyed) -> List[np.ndarray]:
        """Postings through a bitmap a gram (the byte segment, where few
        grams hit many positions)."""
        rows = np.zeros((len(keyed), self.n_docs + 1), dtype=bool)
        for gi, d in self._chunks(seg, *self._tables(seg, keyed)):
            rows[gi, d] = True
        return [np.flatnonzero(r).astype(np.int32) for r in rows]

    def _postings_sorted(self, seg: dict, keyed) -> List[np.ndarray]:
        """Postings through a radix sort of the hits by gram (the code-
        point segment, where many grams hit fewer positions)."""
        parts = list(self._chunks(seg, *self._tables(seg, keyed)))
        gi = np.concatenate([p[0] for p in parts])
        d = np.concatenate([p[1] for p in parts])
        order = np.argsort(gi, kind="stable")      # radix: 16-bit keys
        gi, d = gi[order], d[order]
        bounds = np.searchsorted(gi, np.arange(len(keyed) + 1))
        out = []
        for i in range(len(keyed)):
            x = d[bounds[i]:bounds[i + 1]]         # ascending, repeats
            if x.size:
                keep = np.empty(x.size, dtype=bool)
                keep[0] = True
                np.not_equal(x[1:], x[:-1], out=keep[1:])
                x = x[keep]
            out.append(x)
        return out

    def doc_freq(self) -> Callable[[str], int]:
        """gram -> the number of documents holding it, for every one- and
        two-point gram at once (one sort of (doc, key) pairs a
        segment)."""
        tables = []
        for seg in self.segments:
            a = seg["alpha"]
            K = a + a * a
            sym = seg["sym"].astype(np.int64)
            doc = seg["doc"].astype(np.int64)
            nxt = np.concatenate([sym[1:], [0]])
            pairs = np.unique(np.concatenate([doc * K + sym,
                                              doc * K + a + sym * a + nxt]))
            tables.append((seg, np.bincount(pairs % K, minlength=K)))

        def df(gram: str) -> int:
            return sum(int(counts[k]) for seg, counts in tables
                       if (k := self._key(seg, gram)) >= 0)
        return df

    def postings(self, grams: Iterable[str]) -> Dict[str, np.ndarray]:
        """gram -> sorted distinct doc ids holding it (int32)."""
        grams = sorted(set(grams))
        parts: Dict[str, List[np.ndarray]] = {g: [] for g in grams}
        for seg in self.segments:
            keyed = [(g, self._key(seg, g)) for g in grams]
            keyed = [(g, k) for g, k in keyed if k >= 0]
            step = (BITMAP_BYTES // (self.n_docs + 1) if seg["lut"] is None
                    else NONE)
            for lo in range(0, len(keyed), max(step, 1)):
                group = keyed[lo:lo + step]
                idx = [(i, k) for i, (_, k) in enumerate(group)]
                got = (self._postings_bitmap(seg, idx) if seg["lut"] is None
                       else self._postings_sorted(seg, idx))
                for (g, _), x in zip(group, got):
                    if x.size:
                        parts[g].append(x)
        return {g: (np.empty(0, dtype=np.int32) if not p else p[0]
                    if len(p) == 1 else np.union1d(p[0], p[1]))
                for g, p in parts.items()}


POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)


class Sets:
    """Document sets: a sorted id array, or, for a long posting, a bitmap
    (little-endian bits, packed into bytes); ANDs driven by the shortest
    operand."""

    def __init__(self, n_docs: int):
        self.n_docs = n_docs
        self.bitmaps: Dict[str, np.ndarray] = {}

    def long(self, posting: np.ndarray) -> bool:
        return posting.size * 64 > self.n_docs

    def bitmap(self, key: str, posting: np.ndarray) -> np.ndarray:
        b = self.bitmaps.get(key)
        if b is None:
            m = np.zeros(self.n_docs + 1, dtype=bool)
            m[posting] = True
            b = self.bitmaps[key] = np.packbits(m, bitorder="little")
        return b

    @staticmethod
    def test(bits: np.ndarray, ids: np.ndarray) -> np.ndarray:
        return ((bits[ids >> 3] >> (ids & 7).astype(np.uint8)) & 1) \
            .astype(bool)

    def intersect(self, keyed: List) -> "Result":
        """The docs in every (key, posting)."""
        if not keyed:
            return Result(ids=np.empty(0, dtype=np.int32))
        keyed = sorted(keyed, key=lambda kp: len(kp[1]))
        key, first = keyed[0]
        if self.long(first):  # every operand long: AND the bitmaps
            bits = self.bitmap(key, first).copy()
            for k, p in keyed[1:]:
                np.bitwise_and(bits, self.bitmap(k, p), out=bits)
            return Result(bits=bits)
        ids = first
        for k, p in keyed[1:]:
            if not ids.size:
                break
            if self.long(p):
                ids = ids[self.test(self.bitmap(k, p), ids)]
            else:
                j = np.minimum(np.searchsorted(p, ids), max(p.size - 1, 0))
                ids = ids[p[j] == ids] if p.size else ids[:0]
        return Result(ids=ids)


class Result:
    """A document set as sorted ids or as a bitmap."""

    def __init__(self, ids: Optional[np.ndarray] = None,
                 bits: Optional[np.ndarray] = None):
        self._ids, self.bits = ids, bits

    def count(self) -> int:
        if self._ids is not None:
            return int(self._ids.size)
        return int(POP8[self.bits].sum())

    def ids(self) -> np.ndarray:
        if self._ids is None:
            self._ids = np.flatnonzero(np.unpackbits(
                self.bits, bitorder="little")).astype(np.int32)
        return self._ids

    def top(self, n: int) -> np.ndarray:
        """The n largest ids, largest first."""
        if self._ids is not None:
            return self._ids[::-1][:n]
        nz = np.flatnonzero(self.bits)[::-1][:n]  # the last n bytes set
        bits = np.unpackbits(self.bits[nz[::-1]], bitorder="little")
        base = np.repeat(nz[::-1].astype(np.int64) * 8, 8)
        return (base + np.tile(np.arange(8), nz.size))[bits == 1][::-1][:n]

    def where(self, keep_bits: np.ndarray) -> "Result":
        """This set AND a bitmap."""
        if self._ids is not None:
            return Result(ids=self._ids[Sets.test(keep_bits, self._ids)])
        return Result(bits=self.bits & keep_bits)
