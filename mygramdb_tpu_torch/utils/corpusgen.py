"""Synthetic realistic-scale corpus generator (EN Zipf + JA CJK mixture).

The reference's headline benchmarks run on 1.1M Wikipedia EN+JA articles
(README.md:19-32, support/seed/generate_dump.py downloads CirrusSearch
dumps). This environment has zero egress, so this module synthesizes a
corpus with the same *index-shaping* properties:

- **EN**: >=100k distinct words with a Zipf rank-frequency law. ASCII
  bigrams collapse to a ~1.4k-term dense core with realistic frequency
  skew (as real English does).
- **JA**: ~2.5k distinct kanji (Zipf) mixed with kana runs. With hybrid
  n-grams (kanji unigrams + kana bigrams + cross-boundary bigrams) this
  yields an O(100k)-term dictionary with a long sparse tail — the shape
  that actually exercises the term dict, the sparse CSR path, and HBM
  sizing at Wikipedia scale.

Everything is vectorized numpy and seeded: ~1M docs generate in tens of
seconds and are bit-identical across runs.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

# --------------------------------------------------------------------------
# English vocabulary
# --------------------------------------------------------------------------

_ONSETS = ["b", "br", "c", "ch", "cl", "d", "dr", "f", "fl", "g", "gr", "h",
           "j", "k", "l", "m", "n", "p", "pl", "pr", "qu", "r", "s", "sh",
           "sl", "st", "str", "t", "th", "tr", "v", "w", "y", "z"]
_NUCLEI = ["a", "e", "i", "o", "u", "ai", "ea", "ee", "io", "ou"]
_CODAS = ["", "n", "r", "s", "t", "l", "m", "ck", "ng", "st"]


def make_vocab(n_words: int = 120_000, seed: int = 42) -> List[str]:
    """Deterministic distinct pseudo-English words, 1-4 syllables."""
    rng = np.random.default_rng(seed)
    out: List[str] = []
    seen = set()
    n_on, n_nu, n_co = len(_ONSETS), len(_NUCLEI), len(_CODAS)
    while len(out) < n_words:
        batch = max(n_words - len(out), 4096)
        n_syll = rng.integers(1, 5, size=batch)
        for k in range(batch):
            parts = []
            for _ in range(int(n_syll[k])):
                parts.append(_ONSETS[int(rng.integers(n_on))])
                parts.append(_NUCLEI[int(rng.integers(n_nu))])
            parts.append(_CODAS[int(rng.integers(n_co))])
            w = "".join(parts)
            if w not in seen:
                seen.add(w)
                out.append(w)
    return out[:n_words]


def zipf_cdf(n: int, s: float = 1.07) -> np.ndarray:
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), s)
    c = np.cumsum(w)
    return c / c[-1]


def _zipf_sample(cdf: np.ndarray, size: int, rng) -> np.ndarray:
    return np.searchsorted(cdf, rng.random(size)).astype(np.int64)


# --------------------------------------------------------------------------
# Japanese character pools
# --------------------------------------------------------------------------

def _kanji_pool(n: int = 2500, seed: int = 7) -> np.ndarray:
    """n distinct codepoints from the CJK Unified Ideographs block."""
    rng = np.random.default_rng(seed)
    cps = rng.choice(np.arange(0x4E00, 0x9FD0), size=n, replace=False)
    return cps.astype(np.int64)


_HIRAGANA = np.arange(0x3042, 0x3090, dtype=np.int64)      # あ..わ
_KATAKANA = np.arange(0x30A2, 0x30F0, dtype=np.int64)


class CorpusGenerator:
    """Streaming seeded generator of (pk, text) rows.

    ja_ratio of documents are Japanese (kanji+kana runs, no spaces), the
    rest English (space-separated Zipf words). Doc ids / PKs are 1-based
    sequential, matching the loader's PK-order invariant.
    """

    def __init__(self, n_docs: int, ja_ratio: float = 0.45,
                 vocab_size: int = 120_000, n_kanji: int = 2500,
                 seed: int = 1234,
                 en_words: Tuple[int, int] = (8, 60),
                 ja_chars: Tuple[int, int] = (30, 150)):
        self.n_docs = n_docs
        self.ja_ratio = ja_ratio
        self.seed = seed
        self.en_words = en_words
        self.ja_chars = ja_chars
        self.vocab = make_vocab(vocab_size, seed=seed)
        self.vocab_arr = np.asarray(self.vocab, dtype=object)
        self.en_cdf = zipf_cdf(vocab_size)
        self.kanji = _kanji_pool(n_kanji, seed=seed + 1)
        self.kanji_cdf = zipf_cdf(n_kanji, s=1.05)

    # ---------------- vectorized batch generation ----------------
    def _gen_en_batch(self, count: int, rng) -> List[str]:
        lo, hi = self.en_words
        lens = rng.integers(lo, hi + 1, size=count)
        total = int(lens.sum())
        idx = _zipf_sample(self.en_cdf, total, rng)
        words = self.vocab_arr[idx]
        out = []
        pos = 0
        for L in lens.tolist():
            out.append(" ".join(words[pos:pos + L]))
            pos += L
        return out

    def _gen_ja_batch(self, count: int, rng) -> List[str]:
        lo, hi = self.ja_chars
        lens = rng.integers(lo, hi + 1, size=count)
        total = int(lens.sum())
        # character classes: 62% kanji, 30% hiragana, 8% katakana
        cls = rng.random(total)
        cps = np.empty(total, dtype=np.int64)
        k_mask = cls < 0.62
        h_mask = (cls >= 0.62) & (cls < 0.92)
        t_mask = cls >= 0.92
        cps[k_mask] = self.kanji[_zipf_sample(self.kanji_cdf,
                                              int(k_mask.sum()), rng)]
        cps[h_mask] = _HIRAGANA[rng.integers(0, _HIRAGANA.size,
                                             size=int(h_mask.sum()))]
        cps[t_mask] = _KATAKANA[rng.integers(0, _KATAKANA.size,
                                             size=int(t_mask.sum()))]
        # one C-speed utf-32 decode for the whole batch, then slice:
        # ~100x faster than a per-character chr() join (the generator was
        # half the benchmark build loop's wall time)
        big = cps.astype("<u4").tobytes().decode("utf-32-le")
        out = []
        pos = 0
        for L in lens.tolist():
            out.append(big[pos:pos + L])
            pos += L
        return out

    def batches(self, batch_size: int = 10_000
                ) -> Iterator[List[Tuple[int, str]]]:
        """Yield lists of (doc_id/pk, text); deterministic for a seed."""
        rng = np.random.default_rng(self.seed + 17)
        next_id = 1
        remaining = self.n_docs
        while remaining > 0:
            n = min(batch_size, remaining)
            is_ja = rng.random(n) < self.ja_ratio
            n_ja = int(is_ja.sum())
            ja_texts = self._gen_ja_batch(n_ja, rng) if n_ja else []
            en_texts = self._gen_en_batch(n - n_ja, rng) if n - n_ja else []
            ji = ei = 0
            rows = []
            for i in range(n):
                if is_ja[i]:
                    t = ja_texts[ji]; ji += 1
                else:
                    t = en_texts[ei]; ei += 1
                rows.append((next_id + i, t))
            next_id += n
            remaining -= n
            yield rows

    def rows(self, batch_size: int = 10_000) -> Iterator[Tuple[int, str]]:
        for batch in self.batches(batch_size):
            yield from batch

    # ---------------- query workload sampling ----------------
    def sample_en_terms(self, count: int, rng=None,
                        rank_range: Tuple[int, int] = (0, 5000)) -> List[str]:
        rng = rng or np.random.default_rng(self.seed + 99)
        lo, hi = rank_range
        idx = rng.integers(lo, min(hi, len(self.vocab)), size=count)
        return [self.vocab[int(i)] for i in idx]

    def sample_ja_terms(self, count: int, term_len: int = 2,
                        rng=None) -> List[str]:
        rng = rng or np.random.default_rng(self.seed + 98)
        idx = _zipf_sample(self.kanji_cdf, count * term_len, rng)
        cps = self.kanji[idx]
        big = cps.astype("<u4").tobytes().decode("utf-32-le")
        return [big[i * term_len:(i + 1) * term_len]
                for i in range(count)]
