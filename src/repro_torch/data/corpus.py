"""Synthetic token corpora as lakehouse tables.

Rows: ``pos`` (global token position — the table's sort key, so windows of
token positions are exactly the cache's filter intervals), ``token``
(int32 id), ``doc_id`` (document boundary marker for packing/masking).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core.columnar import Table
from repro_torch.lake.catalog import Catalog

__all__ = ["write_token_corpus", "CORPUS_SCHEMA"]

CORPUS_SCHEMA = {"pos": "<i8", "token": "<i4", "doc_id": "<i4"}


def _gen_stream(
    rng: np.random.Generator,
    num_tokens: int,
    vocab_size: int,
    mean_doc_len: int,
    eos_id: int,
    doc_base: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Markov-ish token stream: per-doc bigram walk + uniform noise, so a
    model trained on it has learnable structure — losses in the e2e example
    must go down, not just run."""
    tokens = np.empty(num_tokens, np.int32)
    doc_ids = np.empty(num_tokens, np.int32)
    i = 0
    doc = doc_base
    while i < num_tokens:
        L = int(rng.geometric(1.0 / mean_doc_len))
        L = min(max(2, L), num_tokens - i)  # last doc may be short
        # bigram walk: next = (prev * a + b) mod V with doc-specific (a, b)
        a = int(rng.integers(2, 64))
        b = int(rng.integers(1, vocab_size))
        t = np.empty(L, np.int64)
        t[0] = rng.integers(1, vocab_size)
        for j in range(1, L):
            if rng.random() < 0.1:
                t[j] = rng.integers(1, vocab_size)
            else:
                t[j] = (t[j - 1] * a + b) % (vocab_size - 1) + 1
        t[-1] = eos_id
        tokens[i : i + L] = t.astype(np.int32)
        doc_ids[i : i + L] = doc
        i += L
        doc += 1
    return tokens, doc_ids


def write_token_corpus(
    catalog: Catalog,
    table: str,  # "namespace.name"
    num_tokens: int,
    vocab_size: int,
    *,
    seed: int = 0,
    mean_doc_len: int = 512,
    eos_id: int = 0,
    start_pos: int = 0,
) -> None:
    """Create (if needed) and append a synthetic corpus — idempotently.

    Idempotent over ``pos``: when the table already holds rows overlapping
    ``[start_pos, start_pos + num_tokens)``, only the missing tail above the
    table's max key is appended (restarted launchers reusing a workdir can
    never duplicate sort keys; a larger rerun tops the corpus up).  A
    top-up tail starts a FRESH document from a seed derived from (seed,
    boundary) — the previous run's final doc already ends in a forced
    ``eos_id``, so the seam is a legitimate doc boundary.  A requested
    range entirely disjoint from the existing rows is written in full
    (explicit ``start_pos`` extension, as the data tests do).
    """
    ns, name = table.rsplit(".", 1)
    end_pos = start_pos + num_tokens
    key_lo = key_hi = None  # existing rows span [key_lo, key_hi]
    try:
        catalog.table(table)
        frags = catalog.current_snapshot(table).live_fragments()
        if frags:
            key_lo = min(f.key_min for f in frags)
            key_hi = max(f.key_max for f in frags)
    except KeyError:
        catalog.create_table(ns, name, CORPUS_SCHEMA, "pos")

    if key_hi is None or end_pos <= key_lo or start_pos > key_hi:
        write_lo = start_pos  # empty table or fully disjoint range
    elif key_hi + 1 >= end_pos:
        return  # overlapping and already covered up to end_pos
    else:
        write_lo = key_hi + 1  # top-up: append the missing tail only
    n_new = end_pos - write_lo

    if write_lo == start_pos:
        rng = np.random.default_rng(seed)
        doc_base = 0
    else:
        rng = np.random.default_rng([seed, write_lo])
        # doc count of the existing run is < write_lo (docs are >= 2 tokens),
        # so position-derived ids cannot collide at the seam
        doc_base = write_lo
    tokens, doc_ids = _gen_stream(
        rng, n_new, vocab_size, mean_doc_len, eos_id, doc_base
    )

    catalog.append(
        table,
        Table(
            {
                "pos": np.arange(write_lo, end_pos, dtype=np.int64),
                "token": tokens,
                "doc_id": doc_ids,
            }
        ),
    )
