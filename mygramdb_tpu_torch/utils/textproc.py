"""Text normalization, UTF-8 handling and n-gram generation.

Semantics follow the reference engine (see /root/reference):

- ``normalize_text``: NFKC -> width conversion -> lowercase, in that order
  (reference ``utils/string_utils.cpp`` NormalizeTextICU). NFKC is the Unicode
  standard transform (Python ``unicodedata`` == ICU). Width "narrow" is ICU's
  Fullwidth-Halfwidth transliteration: fullwidth ASCII -> ASCII, ideographic
  space -> space, katakana -> halfwidth katakana (voiced marks decomposed);
  "wide" is the inverse direction.
- ``generate_hybrid_ngrams``: per-position n-gram size chosen by the *start*
  character: CJK ideograph (Kanji blocks only; kana excluded) -> kanji size,
  else ascii size; optional rejection of n-grams spanning a CJK/non-CJK
  boundary (reference ``string_utils.cpp:460-517``).
- ``utf8_to_codepoints`` / ``sanitize_utf8``: invalid sequences are skipped /
  replaced with U+FFFD (reference ``string_utils.cpp:551-594``).

When the optional C++ native module is available it is used for the hot
paths (n-gram shredding over bulk loads / binlog batches).
"""

from __future__ import annotations

import threading
import unicodedata
from typing import List, Optional, Tuple

# ---------------------------------------------------------------------------
# CJK ideograph detection (Kanji blocks only — Hiragana/Katakana intentionally
# excluded; they use the ASCII n-gram size. Reference string_utils.cpp:449-456)
# ---------------------------------------------------------------------------

_CJK_RANGES: Tuple[Tuple[int, int], ...] = (
    (0x4E00, 0x9FFF),   # CJK Unified Ideographs
    (0x3400, 0x4DBF),   # Extension A
    (0x20000, 0x2A6DF),  # Extension B
    (0x2A700, 0x2B73F),  # Extension C
    (0x2B740, 0x2B81F),  # Extension D
    (0xF900, 0xFAFF),   # Compatibility Ideographs
)


def is_cjk_ideograph(cp: int) -> bool:
    for lo, hi in _CJK_RANGES:
        if lo <= cp <= hi:
            return True
    return False


# Precomputed membership for the BMP fast path.
_CJK_BMP = bytearray(0x10000)
for _lo, _hi in _CJK_RANGES:
    if _hi < 0x10000:
        for _c in range(_lo, _hi + 1):
            _CJK_BMP[_c] = 1


def _is_cjk(cp: int) -> bool:
    if cp < 0x10000:
        return bool(_CJK_BMP[cp])
    return (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F) or (0x2B740 <= cp <= 0x2B81F)


# ---------------------------------------------------------------------------
# Width conversion (ICU Fullwidth-Halfwidth / Halfwidth-Fullwidth analog)
# ---------------------------------------------------------------------------

_KATAKANA_FW = (
    "。「」、・ヲァィゥェォャュョッーアイウエオカキクケコサシスセソ"
    "タチツテトナニヌネノハヒフヘホマミムメモヤユヨラリルレロワン"
)
_KATAKANA_HW = (
    "｡｢｣､･ｦｧｨｩｪｫｬｭｮｯｰｱｲｳｴｵｶｷｸｹｺｻｼｽｾｿ"
    "ﾀﾁﾂﾃﾄﾅﾆﾇﾈﾉﾊﾋﾌﾍﾎﾏﾐﾑﾒﾓﾔﾕﾖﾗﾘﾙﾚﾛﾜﾝ"
)
_VOICED_FW = "ガギグゲゴザジズゼゾダヂヅデドバビブベボヴ"
_VOICED_BASE_HW = "ｶｷｸｹｺｻｼｽｾｿﾀﾁﾂﾃﾄﾊﾋﾌﾍﾎｳ"
_SEMIVOICED_FW = "パピプペポ"
_SEMIVOICED_BASE_HW = "ﾊﾋﾌﾍﾎ"
_HW_VOICED_MARK = "ﾞ"   # ﾞ
_HW_SEMIVOICED_MARK = "ﾟ"  # ﾟ

_NARROW_MAP = {}
for _f, _h in zip(_KATAKANA_FW, _KATAKANA_HW):
    _NARROW_MAP[ord(_f)] = _h
for _f, _h in zip(_VOICED_FW, _VOICED_BASE_HW):
    _NARROW_MAP[ord(_f)] = _h + _HW_VOICED_MARK
for _f, _h in zip(_SEMIVOICED_FW, _SEMIVOICED_BASE_HW):
    _NARROW_MAP[ord(_f)] = _h + _HW_SEMIVOICED_MARK
_NARROW_MAP[0x3000] = " "  # ideographic space
_NARROW_MAP[0x309B] = _HW_VOICED_MARK      # standalone voiced mark
_NARROW_MAP[0x309C] = _HW_SEMIVOICED_MARK  # standalone semi-voiced mark
for _c in range(0xFF01, 0xFF5F):  # fullwidth ASCII -> ASCII
    _NARROW_MAP[_c] = chr(_c - 0xFEE0)

_WIDE_MAP = {}
for _f, _h in zip(_KATAKANA_FW, _KATAKANA_HW):
    _WIDE_MAP[ord(_h)] = _f
_WIDE_MAP[ord(_HW_VOICED_MARK)] = "゛"
_WIDE_MAP[ord(_HW_SEMIVOICED_MARK)] = "゜"
_WIDE_MAP[0x20] = "　"
for _c in range(0x21, 0x7F):  # ASCII -> fullwidth ASCII
    _WIDE_MAP[_c] = chr(_c + 0xFEE0)
# halfwidth voiced combinations merge back into precomposed katakana
_WIDE_VOICED = {}
for _f, _h in zip(_VOICED_FW, _VOICED_BASE_HW):
    _WIDE_VOICED[(_h, _HW_VOICED_MARK)] = _f
for _f, _h in zip(_SEMIVOICED_FW, _SEMIVOICED_BASE_HW):
    _WIDE_VOICED[(_h, _HW_SEMIVOICED_MARK)] = _f


def _to_narrow(text: str) -> str:
    return text.translate(_NARROW_MAP)


def _to_wide(text: str) -> str:
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if i + 1 < n:
            pair = _WIDE_VOICED.get((ch, text[i + 1]))
            if pair is not None:
                out.append(pair)
                i += 2
                continue
        out.append(_WIDE_MAP.get(ord(ch), ch))
        i += 1
    return "".join(out)


# ---------------------------------------------------------------------------
# Normalization failure counter (reference string_utils.h:35)
# ---------------------------------------------------------------------------

_norm_failures = 0
_norm_lock = threading.Lock()


def get_text_normalization_failure_count() -> int:
    return _norm_failures


def reset_text_normalization_failure_count() -> None:
    global _norm_failures
    with _norm_lock:
        _norm_failures = 0


def _record_failure() -> None:
    global _norm_failures
    with _norm_lock:
        _norm_failures += 1


def normalize_text(text: str, nfkc: bool = True, width: str = "narrow",
                   lower: bool = False) -> str:
    """NFKC -> width -> lower, matching the reference pipeline order."""
    try:
        if nfkc:
            text = unicodedata.normalize("NFKC", text)
        if width == "narrow":
            text = _to_narrow(text)
        elif width == "wide":
            text = _to_wide(text)
        if lower:
            text = text.lower()
        return text
    except Exception:
        _record_failure()
        return ""


def normalize_bytes(data: bytes, nfkc: bool = True, width: str = "narrow",
                    lower: bool = False) -> str:
    """Normalize raw bytes; invalid UTF-8 returns "" (reference fail-empty)."""
    try:
        text = data.decode("utf-8")
    except UnicodeDecodeError:
        _record_failure()
        return ""
    return normalize_text(text, nfkc, width, lower)


# ---------------------------------------------------------------------------
# UTF-8 helpers
# ---------------------------------------------------------------------------

def is_valid_utf8(data: bytes) -> bool:
    try:
        data.decode("utf-8")
        return True
    except UnicodeDecodeError:
        return False


def sanitize_utf8(data: bytes) -> str:
    """Decode with U+FFFD replacement for invalid sequences."""
    return data.decode("utf-8", errors="replace")


def utf8_to_codepoints(text: str) -> List[int]:
    return [ord(c) for c in text]


def count_codepoints(text: str) -> int:
    return len(text)


# ---------------------------------------------------------------------------
# N-gram generation
# ---------------------------------------------------------------------------

def generate_ngrams(text: str, n: int) -> List[str]:
    """Codepoint-level sliding-window n-grams (reference string_utils.cpp:390)."""
    if n <= 0 or not text:
        return []
    if n == 1:
        return list(text)
    if len(text) < n:
        return []
    return [text[i:i + n] for i in range(len(text) - n + 1)]


def generate_hybrid_ngrams(text: str, ascii_ngram_size: int = 2,
                           kanji_ngram_size: int = 1,
                           cross_boundary_ngrams: bool = True,
                           kanji_extra: int = 0) -> List[str]:
    """Per-position n size chosen by the start character's script class.

    Reference string_utils.cpp:460-517. CJK-ideograph start -> kanji size;
    anything else (incl. kana) -> ascii size. With cross_boundary False,
    n-grams whose tail mixes CJK/non-CJK relative to the start are skipped.

    kanji_extra > 1 (TPU-native extension, no reference analog): CJK
    positions ALSO emit a kanji_extra-gram when the whole window is CJK.
    A 2-char CJK term then shreds to one exact covering gram (verify_text
    becomes a coverage no-op via the hybrid-fragment rule), and longer
    CJK terms AND overlapping bigrams whose intersection is ~an order of
    magnitude tighter than the unigram AND — the candidate sets the
    device verify has to touch shrink accordingly. Costs extra postings
    (~+40% at ja_ratio 0.45). Index and query sides MUST agree on this
    flag (a query-side gram absent from the index reads as an empty
    term).
    """
    if ascii_ngram_size <= 0 or kanji_ngram_size <= 0 or not text:
        return []
    out: List[str] = []
    cps = text
    n_cp = len(cps)
    is_cjk_flags = [_is_cjk(ord(c)) for c in cps]
    for i in range(n_cp):
        start_is_cjk = is_cjk_flags[i]
        n = kanji_ngram_size if start_is_cjk else ascii_ngram_size
        if i + n <= n_cp:
            crossed = False
            if not cross_boundary_ngrams and n > 1:
                for j in range(1, n):
                    if is_cjk_flags[i + j] != start_is_cjk:
                        crossed = True
                        break
            if not crossed:
                out.append(cps[i:i + n])
        if (kanji_extra > 1 and start_is_cjk
                and kanji_extra != kanji_ngram_size
                and i + kanji_extra <= n_cp
                and all(is_cjk_flags[i + j]
                        for j in range(1, kanji_extra))):
            out.append(cps[i:i + kanji_extra])
    return out


def generate_query_ngrams(normalized: str, ngram_size: int,
                          kanji_ngram_size: int,
                          cross_boundary_ngrams: bool = True,
                          kanji_extra: int = 0) -> List[str]:
    """Dispatch used by both indexing and query paths (string_utils.cpp:647)."""
    if kanji_ngram_size > 0:
        effective = ngram_size if ngram_size > 0 else 2
        return generate_hybrid_ngrams(normalized, effective, kanji_ngram_size,
                                      cross_boundary_ngrams,
                                      kanji_extra=kanji_extra)
    if ngram_size == 0:
        return generate_hybrid_ngrams(normalized)
    return generate_ngrams(normalized, ngram_size)


def query_gram_offsets(normalized: str, ngram_size: int,
                       kanji_ngram_size: int,
                       cross_boundary_ngrams: bool = True,
                       kanji_extra: int = 0
                       ) -> Tuple[List[Tuple[str, int]], bool]:
    """Query grams WITH their in-term start offsets, plus a coverage flag.

    -> ([(gram, offset)], covered). ``covered`` is True when the union of
    the gram spans is every position of the term — the condition under
    which anchored per-gram position equality pins every code point, so
    positional verification (ops/positional_ops.py) is EXACTLY substring
    containment. Terms with coverage gaps (e.g. a trailing non-CJK char
    that starts no gram, like "漢a") must keep the text post-filter —
    the same gap rule as pipeline._coverage_requires_text_check.

    Emission rules mirror generate_query_ngrams exactly: same grams, in
    position order, one per emitting position (repeated grams appear once
    per position — the positional probe needs every placement)."""
    n_cp = len(normalized)
    out: List[Tuple[str, int]] = []
    covered = [False] * n_cp
    if n_cp == 0:
        return out, False
    if kanji_ngram_size > 0 or ngram_size == 0:
        ascii_n = ngram_size if ngram_size > 0 else 2
        kanji_n = kanji_ngram_size if kanji_ngram_size > 0 else 1
        flags = [_is_cjk(ord(c)) for c in normalized]
        for i in range(n_cp):
            n = kanji_n if flags[i] else ascii_n
            if i + n <= n_cp and not (
                    not cross_boundary_ngrams and n > 1 and any(
                        flags[i + j] != flags[i] for j in range(1, n))):
                out.append((normalized[i:i + n], i))
                for j in range(i, i + n):
                    covered[j] = True
            if (kanji_extra > 1 and flags[i]
                    and kanji_extra != kanji_n
                    and i + kanji_extra <= n_cp
                    and all(flags[i + j]
                            for j in range(1, kanji_extra))):
                out.append((normalized[i:i + kanji_extra], i))
                for j in range(i, i + kanji_extra):
                    covered[j] = True
    else:
        n = ngram_size
        if n == 1:
            out = [(c, i) for i, c in enumerate(normalized)]
            covered = [True] * n_cp
        elif n_cp >= n:
            for i in range(n_cp - n + 1):
                out.append((normalized[i:i + n], i))
                for j in range(i, i + n):
                    covered[j] = True
    return out, all(covered)


def format_bytes(num: int) -> str:
    units = ["B", "KB", "MB", "GB", "TB"]
    if num == 0:
        return "0B"
    size = float(num)
    i = 0
    while size >= 1024.0 and i < len(units) - 1:
        size /= 1024.0
        i += 1
    if i == 0:
        return f"{int(size)}B"
    return f"{size:.1f}{units[i]}"
