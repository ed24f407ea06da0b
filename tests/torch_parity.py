"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages get the same inputs, made from a numpy seed; JAX runs on the
CPU (Pallas kernels in interpret mode) and the port on the CPU through its
kernels' plain versions, selected by ``MYGRAM_TORCH_DEVICE=cpu``, which
the ``torch_cpu`` fixture sets. Every comparison is exact: the work is
integer.
"""

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MYGRAM_TORCH_DEVICE", "cpu")
        yield


def require_cuda():
    """Skip the calling test where there is no CUDA device (decided when
    the test runs, never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel against its plain version)")


def u32(t) -> np.ndarray:
    """A torch int32 word tensor or a JAX uint32 array as numpy uint32."""
    if isinstance(t, torch.Tensor):
        return t.cpu().numpy().view(np.uint32)
    return np.asarray(t).view(np.uint32)


def i32(a) -> torch.Tensor:
    """numpy (uint32 or int) -> a CPU int32 tensor with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=True))


def build_corpus(n_docs: int, seed: int = 5, kanji_extra: int = 2):
    """BuiltIndex over the synthetic EN+JA corpus (host builder, shared by
    both packages)."""
    from mygramdb_tpu.index.builder import IndexBuilder
    from mygramdb_tpu.utils.corpusgen import CorpusGenerator
    gen = CorpusGenerator(n_docs, seed=seed, vocab_size=20_000)
    b = IndexBuilder(2, 1, True, kanji_extra_ngram=kanji_extra)
    for batch in gen.batches(1000):
        b.add_batch([(i, t.lower()) for i, t in batch])
    return b.finalize()


def random_queries(built, tdev, n, seed):
    """(tids, not_tids) mixing dense and sparse terms of nonzero df."""
    rng = np.random.default_rng(seed)
    live = np.flatnonzero(built.lengths > 0)
    dense = live[tdev.dense_row[live] >= 0]
    sparse = live[tdev.dense_row[live] < 0]
    common = sparse[built.lengths[sparse] > 20]
    out = []
    for i in range(n):
        shape = i % 5
        if shape == 0:      # all dense
            tids = list(rng.choice(dense, int(rng.integers(1, 4))))
        elif shape == 1:    # sparse driver + dense probes
            tids = [rng.choice(common)] + list(rng.choice(dense, 2))
        elif shape == 2:    # sparse driver + sparse probes
            tids = list(rng.choice(common, 2)) + [rng.choice(sparse)]
        elif shape == 3:    # one sparse term (probe-free)
            tids = [rng.choice(common)]
        else:               # dense + NOT
            tids = [rng.choice(dense)]
        nots = (list(rng.choice(np.concatenate([dense, common]), 2))
                if shape in (1, 4) else [])
        out.append(([int(t) for t in tids], [int(t) for t in nots]))
    return out
