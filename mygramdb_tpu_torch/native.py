"""ctypes bindings for the C++ host kernels (native/mygram_native.cpp).

Loads ``libmygram_native.so`` (built by ``make -C native``; auto-built on
first import when a compiler is available) and exposes vectorized host
operations with transparent Python fallbacks:

- ``substring_verify(texts, needles)`` — verify_text post-filter
- ``count_occurrences(texts, terms)``  — BM25 TF matrix + doc lengths
- ``fuzzy_verify(texts, term, d)``     — fuzzy candidate verification
- ``levenshtein / contains_fuzzy``
- ``intersect/union/difference_sorted``— host id-set algebra
- ``hybrid_ngrams(cps, ...)``          — (start, len, hash) gram triples
- ``TermTable``                        — the exact term table behind
  ``index.term_dict.TermDict``

The port's copy differs from the JAX package's here: it binds the term
table in place of the hash-only ``HashToTid`` (``mg_h2t_*``). The table
is the port's own source, ``csrc/term_table.cpp`` (``mg_tt_*``), built
with the host's C++ compiler into ``build/torch_host/libmygram_terms.so``
of the checkout, anew whenever the source is newer than the library; the
compiler starts with the first load of either library, so the two builds
of a fresh checkout overlap.

Text crosses the boundary as UTF-32 code points: ``str.encode('utf-32-le')``
is a C-speed conversion and code-point offsets match the reference's
semantics exactly.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_LIB_NAME = "libmygram_native.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False

_c_u32p = ctypes.POINTER(ctypes.c_uint32)
_c_i64p = ctypes.POINTER(ctypes.c_int64)
_c_i32p = ctypes.POINTER(ctypes.c_int32)
_c_u8p = ctypes.POINTER(ctypes.c_uint8)
_c_u64p = ctypes.POINTER(ctypes.c_uint64)
_c_u16p = ctypes.POINTER(ctypes.c_uint16)


def _candidate_paths() -> List[str]:
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    return [
        os.environ.get("MYGRAM_NATIVE_LIB", ""),
        os.path.join(root, "native", _LIB_NAME),
        os.path.join(here, _LIB_NAME),
    ]


def _try_build() -> Optional[str]:
    here = os.path.dirname(os.path.abspath(__file__))
    native_dir = os.path.join(os.path.dirname(here), "native")
    if not os.path.isfile(os.path.join(native_dir, "mygram_native.cpp")):
        return None
    try:
        subprocess.run(["make", "-C", native_dir], check=True,
                       capture_output=True, timeout=120)
        path = os.path.join(native_dir, _LIB_NAME)
        return path if os.path.isfile(path) else None
    except Exception:
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("MYGRAM_DISABLE_NATIVE") == "1":
        return None
    _start_terms_build()
    path = next((p for p in _candidate_paths()
                 if p and os.path.isfile(p)), None)
    if path is None:
        path = _try_build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.mg_levenshtein.restype = ctypes.c_int64
    lib.mg_levenshtein.argtypes = [_c_u32p, ctypes.c_int64, _c_u32p,
                                   ctypes.c_int64, ctypes.c_int64]
    lib.mg_contains_fuzzy.restype = ctypes.c_int32
    lib.mg_contains_fuzzy.argtypes = [_c_u32p, ctypes.c_int64, _c_u32p,
                                      ctypes.c_int64, ctypes.c_int64]
    lib.mg_substring_verify.restype = None
    lib.mg_substring_verify.argtypes = [_c_u32p, _c_i64p, ctypes.c_int64,
                                        _c_u32p, _c_i64p, ctypes.c_int64,
                                        _c_u8p]
    lib.mg_count_occurrences.restype = None
    lib.mg_count_occurrences.argtypes = [_c_u32p, _c_i64p, ctypes.c_int64,
                                         _c_u32p, _c_i64p, ctypes.c_int64,
                                         _c_i32p, _c_i32p]
    lib.mg_fuzzy_verify.restype = None
    lib.mg_fuzzy_verify.argtypes = [_c_u32p, _c_i64p, ctypes.c_int64,
                                    _c_u32p, ctypes.c_int64, ctypes.c_int64,
                                    _c_u8p]
    for name in ("mg_intersect_sorted", "mg_union_sorted",
                 "mg_difference_sorted"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [_c_i32p, ctypes.c_int64, _c_i32p, ctypes.c_int64,
                       _c_i32p]
    if hasattr(lib, "mg_hybrid_ngrams_x"):
        lib.mg_hybrid_ngrams_x.restype = ctypes.c_int64
        lib.mg_hybrid_ngrams_x.argtypes = [
            _c_u32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, _c_i32p, _c_i32p, _c_u64p]
        lib.mg_shred_batch_x.restype = ctypes.c_int64
        lib.mg_shred_batch_x.argtypes = [
            _c_u32p, _c_i64p, _c_i32p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _c_i32p,
            _c_i32p, _c_u64p, _c_i32p]
        lib.mg_shred_batch_all_x.restype = ctypes.c_int64
        lib.mg_shred_batch_all_x.argtypes = [
            _c_u32p, _c_i64p, _c_i32p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _c_i32p,
            _c_i32p, _c_u64p, _c_i32p]
    lib.mg_hybrid_ngrams.restype = ctypes.c_int64
    lib.mg_hybrid_ngrams.argtypes = [_c_u32p, ctypes.c_int64,
                                     ctypes.c_int32, ctypes.c_int32,
                                     ctypes.c_int32, _c_i32p, _c_i32p,
                                     _c_u64p]
    try:
        lib.mg_shred_batch.restype = ctypes.c_int64
        lib.mg_shred_batch.argtypes = [_c_u32p, _c_i64p, _c_i32p,
                                       ctypes.c_int64, ctypes.c_int32,
                                       ctypes.c_int32, ctypes.c_int32,
                                       _c_i32p, _c_i32p, _c_u64p, _c_i32p]
    except AttributeError:  # stale .so without the batch entry point
        pass
    try:
        lib.mg_radix_finalize.restype = None
        lib.mg_radix_finalize.argtypes = [_c_i32p, _c_i32p, ctypes.c_int64,
                                          ctypes.c_int32, ctypes.c_int32,
                                          _c_i32p, _c_i32p]
    except AttributeError:  # stale .so without the finalize entry point
        pass
    try:
        lib.mg_tid_hist.restype = None
        lib.mg_tid_hist.argtypes = [_c_i32p, ctypes.c_int64, _c_i64p]
        lib.mg_scatter_rle.restype = None
        lib.mg_scatter_rle.argtypes = [_c_i32p, _c_i32p, _c_i64p,
                                       ctypes.c_int64, _c_i64p, _c_i32p]
    except AttributeError:  # stale .so without the chunked entry points
        pass
    try:
        lib.mg_shred_batch_all.restype = ctypes.c_int64
        lib.mg_shred_batch_all.argtypes = [_c_u32p, _c_i64p, _c_i32p,
                                           ctypes.c_int64, ctypes.c_int32,
                                           ctypes.c_int32, ctypes.c_int32,
                                           _c_i32p, _c_i32p, _c_u64p,
                                           _c_i32p]
        lib.mg_pos_hist.restype = None
        lib.mg_pos_hist.argtypes = [_c_i32p, _c_i32p, _c_i64p,
                                    ctypes.c_int64, _c_i64p, _c_i64p,
                                    _c_i32p]
        lib.mg_scatter_pos.restype = None
        lib.mg_scatter_pos.argtypes = [_c_i32p, _c_i32p, _c_i64p,
                                       ctypes.c_int64, _c_u16p, _c_i64p,
                                       _c_i64p, _c_i32p, _c_i32p, _c_u16p,
                                       _c_u16p]
    except AttributeError:  # stale .so without the positional entry points
        pass
    try:
        lib.mg_utf8_decode_u16.restype = ctypes.c_int64
        lib.mg_utf8_decode_u16.argtypes = [_c_u8p, _c_i64p, _c_i64p,
                                           ctypes.c_int64, _c_u16p,
                                           ctypes.c_uint16, _c_u8p]
    except AttributeError:  # stale .so without the decoder entry point
        pass
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# the term table's library (csrc/term_table.cpp), the port's own
# ---------------------------------------------------------------------------

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_TERMS_SRC = os.path.join(_PKG_DIR, "csrc", "term_table.cpp")
_TERMS_LIB = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_host",
                          "libmygram_terms.so")
_terms_lock = threading.Lock()
_terms_build: Optional[subprocess.Popen] = None
_terms_lib: Optional[ctypes.CDLL] = None
_terms_tried = False
# compiles to a file of its own, then renames it into place: a build that
# outlives the process that started it still leaves a whole library
_TERMS_BUILD_SH = ('lib="$1"; shift; tmp="$lib.$$.tmp"; '
                   '"$@" -o "$tmp" && mv -f "$tmp" "$lib" || '
                   '{ rm -f "$tmp"; exit 1; }')


def _start_terms_build() -> None:
    """Starts the compiler on the term table's source, in the background,
    where its library is missing or older than the source."""
    global _terms_build
    with _terms_lock:
        if _terms_build is not None or _terms_tried:
            return
        try:
            if os.path.getmtime(_TERMS_LIB) >= os.path.getmtime(_TERMS_SRC):
                return
        except OSError:
            if not os.path.isfile(_TERMS_SRC):
                return
        os.makedirs(os.path.dirname(_TERMS_LIB), exist_ok=True)
        try:
            _terms_build = subprocess.Popen(
                ["sh", "-c", _TERMS_BUILD_SH, "sh", _TERMS_LIB,
                 "g++", "-O3", "-march=native",
                 "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared",
                 _TERMS_SRC],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        except OSError:
            pass


def _load_terms() -> Optional[ctypes.CDLL]:
    """The term table's library, built first where it is missing or stale;
    None without a compiler or with ``MYGRAM_DISABLE_NATIVE=1``."""
    global _terms_lib, _terms_tried, _terms_build
    if _terms_lib is not None or _terms_tried:
        return _terms_lib
    if os.environ.get("MYGRAM_DISABLE_NATIVE") == "1":
        return None
    _start_terms_build()
    with _terms_lock:
        if _terms_tried:
            return _terms_lib
        _terms_tried = True
        if _terms_build is not None:
            try:
                _terms_build.wait(timeout=120)
            except subprocess.TimeoutExpired:
                _terms_build.kill()
            _terms_build = None
        try:  # a library older than the source is not loaded
            if os.path.getmtime(_TERMS_LIB) < os.path.getmtime(_TERMS_SRC):
                return None
            lib = ctypes.CDLL(_TERMS_LIB)
            held = ctypes.PyDLL(_TERMS_LIB)
        except OSError:
            return None
        # One gram's call, a query's lookup or a live write's, takes a few
        # us and keeps the interpreter lock: a call that lets it go waits
        # to take it back behind the server's busy threads, which cost
        # far more than the call (the batch calls do let it go).
        lib.mg_tt_size = held.mg_tt_size
        lib.mg_tt_id = held.mg_tt_id
        lib.mg_tt_create.restype = ctypes.c_void_p
        lib.mg_tt_create.argtypes = []
        lib.mg_tt_destroy.restype = None
        lib.mg_tt_destroy.argtypes = [ctypes.c_void_p]
        lib.mg_tt_size.restype = ctypes.c_int64
        lib.mg_tt_size.argtypes = [ctypes.c_void_p]
        # a term crosses as its utf-32-le bytes (no numpy array per call)
        lib.mg_tt_id.restype = ctypes.c_int64
        lib.mg_tt_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_int32, ctypes.c_int32]
        lib.mg_tt_resolve.restype = ctypes.c_int64
        lib.mg_tt_resolve.argtypes = [ctypes.c_void_p, _c_u32p, _c_i32p,
                                      _c_i32p, _c_u64p, ctypes.c_int64,
                                      ctypes.c_int32, _c_i32p, _c_i64p]
        lib.mg_tt_copy.restype = ctypes.c_int64
        lib.mg_tt_copy.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_int64, _c_u32p, ctypes.c_int64,
                                   _c_i64p]
        _terms_lib = lib
        return _terms_lib


# ---------------------------------------------------------------------------
# conversion helpers
# ---------------------------------------------------------------------------

def to_cp(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32)


def pack_texts(texts: Sequence[Optional[str]]) -> Tuple[np.ndarray, np.ndarray]:
    """-> (concat codepoints, offsets (n+1,))."""
    parts = [to_cp(t or "") for t in texts]
    offsets = np.zeros(len(parts) + 1, dtype=np.int64)
    np.cumsum([p.size for p in parts], out=offsets[1:])
    buf = np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint32)
    return np.ascontiguousarray(buf), offsets


def _ptr(arr: np.ndarray, typ):
    return arr.ctypes.data_as(typ)


# ---------------------------------------------------------------------------
# public operations (with fallbacks)
# ---------------------------------------------------------------------------

def substring_verify(texts: Sequence[Optional[str]],
                     needles: Sequence[str]) -> np.ndarray:
    """bool mask: text contains ALL needles."""
    lib = _load()
    if lib is None:
        return np.asarray([t is not None and all(n in t for n in needles)
                           for t in texts], dtype=bool)
    tbuf, toff = pack_texts(texts)
    nbuf, noff = pack_texts(needles)
    out = np.zeros(len(texts), dtype=np.uint8)
    lib.mg_substring_verify(_ptr(tbuf, _c_u32p), _ptr(toff, _c_i64p),
                            len(texts), _ptr(nbuf, _c_u32p),
                            _ptr(noff, _c_i64p), len(needles),
                            _ptr(out, _c_u8p))
    mask = out.astype(bool)
    # None texts never verify
    for i, t in enumerate(texts):
        if t is None:
            mask[i] = False
    return mask


def count_occurrences(texts: Sequence[Optional[str]],
                      terms: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """-> (tf matrix (n_texts, n_terms) int32, doc lengths int32)."""
    lib = _load()
    if lib is None:
        tf = np.zeros((len(texts), len(terms)), dtype=np.int32)
        dl = np.zeros(len(texts), dtype=np.int32)
        for i, t in enumerate(texts):
            if not t:
                continue
            dl[i] = len(t)
            for j, term in enumerate(terms):
                tf[i, j] = t.count(term)
        return tf, dl
    return count_occurrences_packed(*pack_texts(texts), terms)


def count_occurrences_packed(tbuf: np.ndarray, toff: np.ndarray,
                             terms: Sequence[str]
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """``count_occurrences`` over texts already packed as ``pack_texts``
    packs them: tbuf (P,) uint32 code points, toff (n + 1,) int64."""
    n = toff.shape[0] - 1
    lib = _load()
    if lib is None:
        return count_occurrences(
            [tbuf[toff[i]:toff[i + 1]].tobytes().decode("utf-32-le")
             for i in range(n)], terms)
    tbuf = np.ascontiguousarray(tbuf, dtype=np.uint32)
    toff = np.ascontiguousarray(toff, dtype=np.int64)
    qbuf, qoff = pack_texts(terms)
    tf = np.zeros((n, len(terms)), dtype=np.int32)
    dl = np.zeros(n, dtype=np.int32)
    lib.mg_count_occurrences(_ptr(tbuf, _c_u32p), _ptr(toff, _c_i64p),
                             n, _ptr(qbuf, _c_u32p),
                             _ptr(qoff, _c_i64p), len(terms),
                             _ptr(tf, _c_i32p), _ptr(dl, _c_i32p))
    return tf, dl


def fuzzy_verify(texts: Sequence[Optional[str]], term: str,
                 max_distance: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        from .utils.edit_distance import contains_fuzzy_match
        return np.asarray(
            [t is not None and (term in t or
                                contains_fuzzy_match(t, term, max_distance))
             for t in texts], dtype=bool)
    tbuf, toff = pack_texts(texts)
    tcp = to_cp(term)
    out = np.zeros(len(texts), dtype=np.uint8)
    lib.mg_fuzzy_verify(_ptr(tbuf, _c_u32p), _ptr(toff, _c_i64p), len(texts),
                        _ptr(np.ascontiguousarray(tcp), _c_u32p), tcp.size,
                        max_distance, _ptr(out, _c_u8p))
    mask = out.astype(bool)
    for i, t in enumerate(texts):
        if t is None:
            mask[i] = False
    return mask


def levenshtein(a: str, b: str, max_distance: int = 2 ** 30) -> int:
    lib = _load()
    if lib is None:
        from .utils.edit_distance import levenshtein as py_lev
        return py_lev(a, b, max_distance)
    ca, cb = to_cp(a), to_cp(b)
    return int(lib.mg_levenshtein(
        _ptr(np.ascontiguousarray(ca), _c_u32p), ca.size,
        _ptr(np.ascontiguousarray(cb), _c_u32p), cb.size, max_distance))


def radix_finalize(tids: np.ndarray, docs: np.ndarray, V: int,
                   n_threads: int = 0):
    """Parallel stable counting sort of (tid, doc) pairs by tid — the
    index builder's finalize. Returns (postings int32, lengths int32) or
    None when the native library is unavailable (caller falls back to the
    numpy argsort path). Stability keeps per-term docs in arrival order."""
    lib = _load()
    if lib is None or not hasattr(lib, "mg_radix_finalize"):
        return None
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8)
    tids = np.ascontiguousarray(tids, dtype=np.int32)
    docs = np.ascontiguousarray(docs, dtype=np.int32)
    postings = np.empty(tids.size, dtype=np.int32)
    lengths = np.zeros(max(V, 1), dtype=np.int32)
    lib.mg_radix_finalize(_ptr(tids, _c_i32p), _ptr(docs, _c_i32p),
                          tids.size, V, n_threads,
                          _ptr(postings, _c_i32p), _ptr(lengths, _c_i32p))
    return postings, lengths[:V]


def radix_finalize_chunked(chunks, V: int):
    """Chunked + RLE-docs variant of radix_finalize: avoids materializing
    the concatenated (tid, doc) pair stream (its peak cost is ~2 GB per 1M
    docs at ~100 grams/doc — the builder's dominant host-RSS spike).

    chunks: iterable of (tids int32 (E_c,), doc_ids int32 (D_c,),
    doc_counts int64 (D_c,)) in stream order, where doc_ids[j] repeats
    doc_counts[j] times (sum == E_c). Consumed chunks are NOT freed here —
    the caller drops its references as it goes.
    Returns (postings int32, lengths int32) or None when the native
    library lacks the entry points (caller falls back to the pair path).
    """
    lib = _load()
    if lib is None or not hasattr(lib, "mg_tid_hist"):
        return None
    counts = np.zeros(max(V, 1), dtype=np.int64)
    E = 0
    for tids, _ids, _cnts in chunks:
        tids = np.ascontiguousarray(tids, dtype=np.int32)
        lib.mg_tid_hist(_ptr(tids, _c_i32p), tids.size,
                        _ptr(counts, _c_i64p))
        E += int(tids.size)
    cursors = np.zeros(max(V, 1), dtype=np.int64)
    np.cumsum(counts[:-1], out=cursors[1:])
    postings = np.empty(E, dtype=np.int32)
    for tids, doc_ids, doc_counts in chunks:
        tids = np.ascontiguousarray(tids, dtype=np.int32)
        doc_ids = np.ascontiguousarray(doc_ids, dtype=np.int32)
        doc_counts = np.ascontiguousarray(doc_counts, dtype=np.int64)
        lib.mg_scatter_rle(_ptr(tids, _c_i32p), _ptr(doc_ids, _c_i32p),
                           _ptr(doc_counts, _c_i64p), doc_ids.size,
                           _ptr(cursors, _c_i64p), _ptr(postings, _c_i32p))
    return postings, counts[:V].astype(np.int32)


def utf8_decode_u16(blob: np.ndarray, byte_off: np.ndarray,
                    cp_off: np.ndarray, out: np.ndarray,
                    sentinel: int = 0xFFFF):
    """One-pass UTF-8 -> UTF-16 corpus decode into a caller-allocated
    uint16 buffer (see mg_utf8_decode_u16). Returns a per-doc bad-flag
    uint8 array (non-BMP / malformed docs -> host verify path), or None
    when the native library lacks the entry point (caller falls back to
    the Python decode route)."""
    lib = _load()
    if lib is None or not hasattr(lib, "mg_utf8_decode_u16"):
        return None
    n_docs = byte_off.size - 1
    blob = np.ascontiguousarray(blob, dtype=np.uint8)
    byte_off = np.ascontiguousarray(byte_off, dtype=np.int64)
    cp_off = np.ascontiguousarray(cp_off, dtype=np.int64)
    assert out.dtype == np.uint16 and out.flags.c_contiguous
    assert out.size >= int(cp_off[-1])
    bad = np.zeros(max(n_docs, 1), dtype=np.uint8)
    lib.mg_utf8_decode_u16(_ptr(blob, _c_u8p), _ptr(byte_off, _c_i64p),
                           _ptr(cp_off, _c_i64p), n_docs,
                           _ptr(out, _c_u16p), sentinel,
                           _ptr(bad, _c_u8p))
    return bad[:n_docs]


def intersect_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _load()
    a = np.ascontiguousarray(a, dtype=np.int32)
    b = np.ascontiguousarray(b, dtype=np.int32)
    if lib is None:
        return np.intersect1d(a, b, assume_unique=True).astype(np.int32)
    out = np.empty(min(a.size, b.size), dtype=np.int32)
    n = lib.mg_intersect_sorted(_ptr(a, _c_i32p), a.size,
                                _ptr(b, _c_i32p), b.size, _ptr(out, _c_i32p))
    return out[:n]


def union_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _load()
    a = np.ascontiguousarray(a, dtype=np.int32)
    b = np.ascontiguousarray(b, dtype=np.int32)
    if lib is None:
        return np.union1d(a, b).astype(np.int32)
    out = np.empty(a.size + b.size, dtype=np.int32)
    n = lib.mg_union_sorted(_ptr(a, _c_i32p), a.size,
                            _ptr(b, _c_i32p), b.size, _ptr(out, _c_i32p))
    return out[:n]


def difference_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _load()
    a = np.ascontiguousarray(a, dtype=np.int32)
    b = np.ascontiguousarray(b, dtype=np.int32)
    if lib is None:
        return np.setdiff1d(a, b, assume_unique=True).astype(np.int32)
    out = np.empty(a.size, dtype=np.int32)
    n = lib.mg_difference_sorted(_ptr(a, _c_i32p), a.size,
                                 _ptr(b, _c_i32p), b.size,
                                 _ptr(out, _c_i32p))
    return out[:n]


def hybrid_ngrams(text: str, ascii_n: int, kanji_n: int,
                  cross_boundary: bool, kanji_extra: int = 0
                  ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """-> (starts, lens, hashes) or None when the native lib is absent
    (or lacks the kanji_extra entry point a non-zero kanji_extra needs)."""
    lib = _load()
    if lib is None:
        return None
    if kanji_extra > 1 and not hasattr(lib, "mg_hybrid_ngrams_x"):
        return None  # stale .so: caller uses the pure-python shredder
    cps = np.ascontiguousarray(to_cp(text))
    n = cps.size
    if n == 0:
        z32 = np.zeros(0, dtype=np.int32)
        return z32, z32, np.zeros(0, dtype=np.uint64)
    cap = n * (2 if kanji_extra > 1 else 1)
    starts = np.empty(cap, dtype=np.int32)
    lens = np.empty(cap, dtype=np.int32)
    hashes = np.empty(cap, dtype=np.uint64)
    if kanji_extra > 1:
        count = lib.mg_hybrid_ngrams_x(
            _ptr(cps, _c_u32p), n, ascii_n, kanji_n,
            1 if cross_boundary else 0, kanji_extra,
            _ptr(starts, _c_i32p), _ptr(lens, _c_i32p),
            _ptr(hashes, _c_u64p))
    else:
        count = lib.mg_hybrid_ngrams(
            _ptr(cps, _c_u32p), n, ascii_n, kanji_n,
            1 if cross_boundary else 0,
            _ptr(starts, _c_i32p), _ptr(lens, _c_i32p),
            _ptr(hashes, _c_u64p))
    return starts[:count], lens[:count], hashes[:count]


def shred_batch(texts, ascii_n: int, kanji_n: int, cross_boundary: bool,
                kanji_extra: int = 0):
    """Shred a whole batch of normalized texts in ONE native call with
    per-doc dedup. -> (flat_cps, starts, lens, hashes, doc_counts) or None.

    starts index into flat_cps; doc_counts[i] = grams of texts[i]."""
    lib = _load()
    if lib is None or not hasattr(lib, "mg_shred_batch"):
        return None
    if kanji_extra > 1 and not hasattr(lib, "mg_shred_batch_x"):
        return None
    n_docs = len(texts)
    if n_docs == 0:
        z32 = np.zeros(0, dtype=np.int32)
        return (np.zeros(0, dtype=np.uint32), z32, z32,
                np.zeros(0, dtype=np.uint64), z32)
    # ONE join + ONE utf-32 encode for the whole batch (no separators —
    # offsets delimit docs): ~4x cheaper than a per-doc to_cp + concat,
    # and len(str) == code points so doc_len needs no decode pass
    flat = np.frombuffer("".join(texts).encode("utf-32-le"),
                         dtype=np.uint32)
    doc_len = np.asarray([len(t) for t in texts], dtype=np.int32)
    doc_off = np.zeros(n_docs, dtype=np.int64)
    np.cumsum(doc_len[:-1], out=doc_off[1:])
    cap = max(int(flat.size) * (2 if kanji_extra > 1 else 1), 1)
    starts = np.empty(cap, dtype=np.int32)
    lens = np.empty(cap, dtype=np.int32)
    hashes = np.empty(cap, dtype=np.uint64)
    counts = np.empty(n_docs, dtype=np.int32)
    if kanji_extra > 1:
        total = lib.mg_shred_batch_x(
            _ptr(flat, _c_u32p), _ptr(doc_off, _c_i64p),
            _ptr(doc_len, _c_i32p), n_docs, ascii_n, kanji_n,
            1 if cross_boundary else 0, kanji_extra,
            _ptr(starts, _c_i32p), _ptr(lens, _c_i32p),
            _ptr(hashes, _c_u64p), _ptr(counts, _c_i32p))
    else:
        total = lib.mg_shred_batch(
            _ptr(flat, _c_u32p), _ptr(doc_off, _c_i64p),
            _ptr(doc_len, _c_i32p), n_docs, ascii_n, kanji_n,
            1 if cross_boundary else 0, _ptr(starts, _c_i32p),
            _ptr(lens, _c_i32p), _ptr(hashes, _c_u64p),
            _ptr(counts, _c_i32p))
    return flat, starts[:total], lens[:total], hashes[:total], counts


def shred_batch_all(texts, ascii_n: int, kanji_n: int,
                    cross_boundary: bool, kanji_extra: int = 0):
    """Shred a batch WITHOUT dedup: one (start, len, hash) entry per gram
    OCCURRENCE in (doc, position) order — the positional-index input.
    -> (flat_cps, starts, lens, hashes, doc_counts) or None."""
    lib = _load()
    if lib is None or not hasattr(lib, "mg_shred_batch_all"):
        return None
    if kanji_extra > 1 and not hasattr(lib, "mg_shred_batch_all_x"):
        return None
    n_docs = len(texts)
    if n_docs == 0:
        z32 = np.zeros(0, dtype=np.int32)
        return (np.zeros(0, dtype=np.uint32), z32, z32,
                np.zeros(0, dtype=np.uint64), z32)
    flat = np.frombuffer("".join(texts).encode("utf-32-le"),
                         dtype=np.uint32)
    doc_len = np.asarray([len(t) for t in texts], dtype=np.int32)
    doc_off = np.zeros(n_docs, dtype=np.int64)
    np.cumsum(doc_len[:-1], out=doc_off[1:])
    cap = max(int(flat.size) * (2 if kanji_extra > 1 else 1), 1)
    starts = np.empty(cap, dtype=np.int32)
    lens = np.empty(cap, dtype=np.int32)
    hashes = np.empty(cap, dtype=np.uint64)
    counts = np.empty(n_docs, dtype=np.int32)
    if kanji_extra > 1:
        total = lib.mg_shred_batch_all_x(
            _ptr(flat, _c_u32p), _ptr(doc_off, _c_i64p),
            _ptr(doc_len, _c_i32p), n_docs, ascii_n, kanji_n,
            1 if cross_boundary else 0, kanji_extra,
            _ptr(starts, _c_i32p), _ptr(lens, _c_i32p),
            _ptr(hashes, _c_u64p), _ptr(counts, _c_i32p))
    else:
        total = lib.mg_shred_batch_all(
            _ptr(flat, _c_u32p), _ptr(doc_off, _c_i64p),
            _ptr(doc_len, _c_i32p), n_docs, ascii_n, kanji_n,
            1 if cross_boundary else 0, _ptr(starts, _c_i32p),
            _ptr(lens, _c_i32p), _ptr(hashes, _c_u64p),
            _ptr(counts, _c_i32p))
    return flat, starts[:total], lens[:total], hashes[:total], counts


def pos_finalize_chunked(chunks, V: int):
    """Two-pass positional finalize over occurrence chunks (the native
    analog of positional.finalize_positions_np, chunk-streaming so the
    concatenated occurrence stream never materializes).

    chunks: iterable of (tids int32 (E_c,), doc_ids int32 (D_c,),
    doc_counts int64 (D_c,), pos uint16 (E_c,)) in stream order.
    Returns (postings int32, lengths int32, occ_cnt uint16,
    occ_pos uint16 OCC_ALIGN-aligned regions, occ_base int64,
    occ_len int64) or None when the native entry points are
    unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "mg_pos_hist"):
        return None
    Vp = max(V, 1)
    occ_counts = np.zeros(Vp, dtype=np.int64)
    uniq_counts = np.zeros(Vp, dtype=np.int64)
    last_doc = np.full(Vp, -1, dtype=np.int32)
    for tids, doc_ids, doc_counts, _pos in chunks:
        tids = np.ascontiguousarray(tids, dtype=np.int32)
        doc_ids = np.ascontiguousarray(doc_ids, dtype=np.int32)
        doc_counts = np.ascontiguousarray(doc_counts, dtype=np.int64)
        lib.mg_pos_hist(_ptr(tids, _c_i32p), _ptr(doc_ids, _c_i32p),
                        _ptr(doc_counts, _c_i64p), doc_ids.size,
                        _ptr(occ_counts, _c_i64p),
                        _ptr(uniq_counts, _c_i64p),
                        _ptr(last_doc, _c_i32p))
    from .index.positional import OCC_ALIGN
    P = int(uniq_counts.sum())
    aligned = (occ_counts + OCC_ALIGN - 1) & ~np.int64(OCC_ALIGN - 1)
    occ_base = np.zeros(Vp, dtype=np.int64)
    np.cumsum(aligned[:-1], out=occ_base[1:])
    O8 = int(aligned.sum())
    doc_cursors = np.zeros(Vp, dtype=np.int64)
    np.cumsum(uniq_counts[:-1], out=doc_cursors[1:])
    occ_cursors = occ_base.copy()
    last_doc.fill(-1)
    postings = np.empty(max(P, 1), dtype=np.int32)
    occ_cnt = np.zeros(max(P, 1), dtype=np.uint16)
    occ_pos = np.full(max(O8, OCC_ALIGN), 0xFFFF, dtype=np.uint16)
    for tids, doc_ids, doc_counts, pos in chunks:
        tids = np.ascontiguousarray(tids, dtype=np.int32)
        doc_ids = np.ascontiguousarray(doc_ids, dtype=np.int32)
        doc_counts = np.ascontiguousarray(doc_counts, dtype=np.int64)
        pos = np.ascontiguousarray(pos, dtype=np.uint16)
        lib.mg_scatter_pos(_ptr(tids, _c_i32p), _ptr(doc_ids, _c_i32p),
                           _ptr(doc_counts, _c_i64p), doc_ids.size,
                           _ptr(pos, _c_u16p), _ptr(doc_cursors, _c_i64p),
                           _ptr(occ_cursors, _c_i64p),
                           _ptr(last_doc, _c_i32p),
                           _ptr(postings, _c_i32p),
                           _ptr(occ_cnt, _c_u16p), _ptr(occ_pos, _c_u16p))
    lengths = uniq_counts.astype(np.int32)[:V]
    return (postings[:P], lengths, occ_cnt[:P], occ_pos,
            occ_base[:V], occ_counts[:V])


def _utf32(text: str) -> bytes:
    return text.encode("utf-32-le", "surrogatepass")


class TermTable:
    """The exact native term table (mg_tt_*): gram -> dense term id, every
    term's code points in one arena, equality on code points and not on
    the hash alone. Backs the port's ``index.term_dict.TermDict``. Terms
    cross as UTF-32 with lone surrogates passed through, as a str holds
    them.
    ``create()`` returns None when its library is not loaded."""

    __slots__ = ("_lib", "_h")

    def __init__(self, lib, handle):
        self._lib = lib
        self._h = handle

    @classmethod
    def create(cls) -> Optional["TermTable"]:
        lib = _load_terms()
        if lib is None:
            return None
        h = lib.mg_tt_create()
        return cls(lib, h) if h else None

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mg_tt_destroy(self._h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.mg_tt_size(self._h))

    def id_of(self, term: str, add: bool) -> int:
        """The term's id; -1 when it is absent and not ``add``."""
        b = _utf32(term)
        return int(self._lib.mg_tt_id(self._h, b, len(b) >> 2,
                                      1 if add else 0))

    def resolve(self, flat: np.ndarray, starts: np.ndarray,
                lens: np.ndarray, hashes: Optional[np.ndarray],
                in_order: bool) -> Tuple[np.ndarray, int]:
        """Grams flat[starts[i]:starts[i] + lens[i]] (hashed by ``hashes``,
        or in C where None) -> (ids int32, term_collisions), adding the
        new grams: numbered by (hash, code points), the bulk build's
        order, or ``in_order`` of input."""
        flat = np.ascontiguousarray(flat, dtype=np.uint32)
        starts = np.ascontiguousarray(starts, dtype=np.int32)
        lens = np.ascontiguousarray(lens, dtype=np.int32)
        n = starts.size
        if lens.size != n or (n and (
                int(starts.min()) < 0 or int(lens.min()) < 0 or
                int((starts.astype(np.int64) + lens).max()) > flat.size)):
            raise ValueError("gram spans out of the code-point buffer")
        if hashes is not None:
            hashes = np.ascontiguousarray(hashes, dtype=np.uint64)
            if hashes.size != n:
                raise ValueError("one hash a gram")
        ids = np.empty(n, dtype=np.int32)
        collisions = ctypes.c_int64(0)
        self._lib.mg_tt_resolve(
            self._h, _ptr(flat, _c_u32p), _ptr(starts, _c_i32p),
            _ptr(lens, _c_i32p),
            None if hashes is None else _ptr(hashes, _c_u64p), n,
            1 if in_order else 0, _ptr(ids, _c_i32p),
            ctypes.byref(collisions))
        return ids, int(collisions.value)

    def add_in_order(self, terms: Sequence[str]) -> np.ndarray:
        """Get-or-add of each term, in order, in one call -> ids."""
        flat = np.frombuffer(_utf32("".join(terms)), dtype=np.uint32)
        lens = np.fromiter(map(len, terms), dtype=np.int32,
                           count=len(terms))
        starts = np.zeros(lens.size, dtype=np.int32)
        np.cumsum(lens[:-1], out=starts[1:])
        return self.resolve(flat, starts, lens, None, True)[0]

    def terms(self, lo: int = 0, hi: Optional[int] = None) -> List[str]:
        """Terms [lo, hi) as strings, decoded in one pass."""
        if hi is None:
            hi = len(self)
        if not 0 <= lo <= hi <= len(self):
            raise IndexError("term id out of range")
        off = np.empty(hi - lo + 1, dtype=np.int64)
        need = self._lib.mg_tt_copy(self._h, lo, hi, None, 0,
                                    _ptr(off, _c_i64p))
        cps = np.empty(max(need, 1), dtype=np.uint32)
        self._lib.mg_tt_copy(self._h, lo, hi, _ptr(cps, _c_u32p), need,
                             _ptr(off, _c_i64p))
        text = cps[:need].tobytes().decode("utf-32-le", "surrogatepass")
        o = off.tolist()
        return [text[o[j]:o[j + 1]] for j in range(hi - lo)]
