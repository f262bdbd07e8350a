"""Sequence packing: variable-length documents → fixed (S,) rows.

Greedy first-fit packing with cross-document loss masking: a label is
trained on only when its context window lies within the same document
(positions where ``doc_id`` changes get mask 0, so no document predicts
the next document's first token).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["pack_documents", "mask_from_doc_ids"]


def mask_from_doc_ids(doc_ids: np.ndarray) -> np.ndarray:
    """(…, S+1) doc ids → (…, S) float mask for next-token targets:
    target t (predicting position t+1) counts iff both sides share a doc."""
    return (doc_ids[..., 1:] == doc_ids[..., :-1]).astype(np.float32)


def pack_documents(
    docs: Sequence[np.ndarray],
    seq_len: int,
    *,
    pad_id: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy first-fit-decreasing packing.

    Returns (tokens (R, S+1), doc_ids (R, S+1), n_padding) where R is the
    number of packed rows.  Documents longer than S+1 are split.
    """
    S1 = seq_len + 1
    pieces: List[np.ndarray] = []
    for d in docs:
        d = np.asarray(d)
        for s in range(0, len(d), S1):
            pieces.append(d[s : s + S1])
    order = np.argsort([-len(p) for p in pieces], kind="stable")
    rows: List[List[np.ndarray]] = []
    space: List[int] = []
    row_docs: List[List[int]] = []
    for piece_i in order:
        p = pieces[piece_i]
        placed = False
        for r in range(len(rows)):
            if space[r] >= len(p):
                rows[r].append(p)
                row_docs[r].append(piece_i)
                space[r] -= len(p)
                placed = True
                break
        if not placed:
            rows.append([p])
            row_docs.append([piece_i])
            space.append(S1 - len(p))

    R = len(rows)
    tokens = np.full((R, S1), pad_id, np.int32)
    doc_ids = np.full((R, S1), -1, np.int32)
    for r, (parts, ids) in enumerate(zip(rows, row_docs)):
        at = 0
        for p, pid in zip(parts, ids):
            tokens[r, at : at + len(p)] = p
            doc_ids[r, at : at + len(p)] = pid
            at += len(p)
    n_pad = int((doc_ids == -1).sum())
    return tokens, doc_ids, n_pad
