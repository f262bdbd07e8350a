"""A token corpus drawn from the seed: documents of geometric length (at
least 2 tokens) with uniform token ids, each ending in the end-of-text id,
laid end to end.  Its columns are ``data/corpus.py``'s (``pos``, ``token``,
``doc_id``), so ``TokenBatchPipeline`` reads it as it reads a corpus the
program wrote, and the benchmark keeps the arrays to check every batch the
pipeline serves.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

SCHEMA = {"pos": "<i8", "token": "<i4", "doc_id": "<i4"}


def tokens(seed: int, count: int, vocab: int, mean_doc_len: int, eos_id: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng([seed, 2])
    lengths = np.maximum(rng.geometric(1.0 / mean_doc_len, count // 2 + 2), 2)
    ends = np.cumsum(lengths)
    n_docs = int(np.searchsorted(ends, count)) + 1
    doc_id = np.repeat(np.arange(n_docs, dtype=np.int32), lengths[:n_docs])[:count]
    tok = rng.integers(1, vocab, count, dtype=np.int32)
    tok[(ends[:n_docs] - 1)[ends[:n_docs] - 1 < count]] = eos_id
    return {"pos": np.arange(count, dtype=np.int64), "token": tok, "doc_id": doc_id}


def batch(corpus: Dict[str, np.ndarray], step: int, global_batch: int, seq_len: int) -> Dict[str, np.ndarray]:
    """The batch of ``step`` as the pipeline's contract defines it: the
    step's ``global_batch x (seq_len + 1)`` tokens, shifted by one for the
    labels, a label counted only inside its document."""
    per = global_batch * (seq_len + 1)
    lo = step * per
    toks = corpus["token"][lo:lo + per].reshape(global_batch, seq_len + 1)
    docs = corpus["doc_id"][lo:lo + per].reshape(global_batch, seq_len + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "loss_mask": (docs[:, 1:] == docs[:, :-1]).astype(np.float32)}
