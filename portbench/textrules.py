"""Text rules the reference needs, frozen here: the normalization and the
query n-gram emission of the configuration's table.

They restate the engine's documented semantics (reference
``utils/string_utils.cpp``): text is normalized by NFKC, then ICU's
Fullwidth-Halfwidth transliteration (fullwidth ASCII to ASCII, the
ideographic space to a space, katakana to halfwidth katakana with the voiced
marks decomposed); nothing is lowercased by default. A query term is cut
into hybrid n-grams: a position that starts with a CJK ideograph (the kanji
blocks, not kana) emits a ``kanji_ngram_size`` gram, any other position an
``ngram_size`` gram, and, with ``kanji_extra_ngram`` > 1, a CJK position
whose next characters are CJK too emits that longer gram as well.

This module imports nothing of the program.
"""

from __future__ import annotations

import functools
import re
import unicodedata
from typing import List

_CJK_RANGES = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
               (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0xF900, 0xFAFF))


_CJK_BMP = bytearray(0x10000)
for _lo, _hi in _CJK_RANGES:
    if _hi <= 0xFFFF:
        _CJK_BMP[_lo:_hi + 1] = b"\x01" * (_hi - _lo + 1)
CJK_RUN = re.compile("[" + "".join(f"{chr(lo)}-{chr(hi)}"
                                   for lo, hi in _CJK_RANGES) + "]+")


def is_cjk(ch: str) -> bool:
    cp = ord(ch)
    if cp <= 0xFFFF:
        return bool(_CJK_BMP[cp])
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


_KATAKANA_FW = ("。「」、・ヲァィゥェォャュョッーアイウエオカキクケコサシスセソ"
                "タチツテトナニヌネノハヒフヘホマミムメモヤユヨラリルレロワン")
_KATAKANA_HW = ("｡｢｣､･ｦｧｨｩｪｫｬｭｮｯｰｱｲｳｴｵｶｷｸｹｺｻｼｽｾｿ"
                "ﾀﾁﾂﾃﾄﾅﾆﾇﾈﾉﾊﾋﾌﾍﾎﾏﾐﾑﾒﾓﾔﾕﾖﾗﾘﾙﾚﾛﾜﾝ")
_VOICED_FW = "ガギグゲゴザジズゼゾダヂヅデドバビブベボヴ"
_VOICED_BASE_HW = "ｶｷｸｹｺｻｼｽｾｿﾀﾁﾂﾃﾄﾊﾋﾌﾍﾎｳ"
_SEMIVOICED_FW = "パピプペポ"
_SEMIVOICED_BASE_HW = "ﾊﾋﾌﾍﾎ"

NARROW = {ord(f): h for f, h in zip(_KATAKANA_FW, _KATAKANA_HW)}
NARROW.update({ord(f): h + "ﾞ" for f, h in zip(_VOICED_FW,
                                               _VOICED_BASE_HW)})
NARROW.update({ord(f): h + "ﾟ" for f, h in zip(_SEMIVOICED_FW,
                                               _SEMIVOICED_BASE_HW)})
NARROW.update({0x3000: " ", 0x309B: "ﾞ", 0x309C: "ﾟ"})
NARROW.update({c: chr(c - 0xFEE0) for c in range(0xFF01, 0xFF5F)})


def normalize(text: str) -> str:
    """NFKC, then fullwidth to halfwidth (the table's default
    normalization). ASCII text is returned as it is."""
    if text.isascii():
        return text
    return unicodedata.normalize("NFKC", text).translate(NARROW)


def query_grams(term: str, table: dict) -> List[str]:
    """The distinct grams a normalized query term is searched by. A gram
    equal to the whole term stands alone: a document holds the term
    exactly when it holds that gram."""
    return list(_grams(term, table["ngram_size"], table["kanji_ngram_size"],
                       table["kanji_extra_ngram"]))


@functools.lru_cache(maxsize=1 << 17)
def _grams(term: str, n_ascii: int, n_kanji: int, extra: int) -> tuple:
    extra = extra if extra > 1 else 0
    flags = [is_cjk(c) for c in term]
    out = []
    for i in range(len(term)):
        n = n_kanji if flags[i] else n_ascii
        if i + n <= len(term):
            out.append(term[i:i + n])
        if (extra and flags[i] and extra != n_kanji
                and i + extra <= len(term)
                and all(flags[i + 1:i + extra])):
            out.append(term[i:i + extra])
    grams = tuple(sorted(set(out)))
    return (term,) if term in grams else grams


def normalize_all(texts: List[str]) -> List[str]:
    """[normalize(t) for t in texts], the width map done on code-point
    arrays: the same strings, in a fraction of the time."""
    import numpy as np
    out = list(texts)
    wide = [i for i, t in enumerate(texts) if not t.isascii()]
    if not wide:
        return out
    joined = unicodedata.normalize("NFKC", "\0".join(texts[i]
                                                     for i in wide))
    cp = np.frombuffer(joined.encode("utf-32-le"), dtype=np.uint32)
    if cp.size and int(cp.max()) > 0xFFFF:
        joined = joined.translate(NARROW)
    else:
        first = np.arange(0x10000, dtype=np.uint32)
        second = np.zeros(0x10000, dtype=np.uint32)
        for c, to in NARROW.items():
            first[c] = ord(to[0])
            if len(to) == 2:
                second[c] = ord(to[1])
        two = second[cp] != 0
        pos = np.arange(cp.size) + np.cumsum(two) - two
        res = np.empty(cp.size + int(two.sum()), dtype=np.uint32)
        res[pos] = first[cp]
        res[pos[two] + 1] = second[cp[two]]
        joined = res.astype("<u4").tobytes().decode("utf-32-le")
    for i, t in zip(wide, joined.split("\0")):
        out[i] = t
    return out
