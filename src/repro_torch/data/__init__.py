"""Training-data pipeline: lakehouse tables → packed token batches.

This is where the paper's data-preprocessing layer meets the trainer: token
corpora live as Iceberg-style tables in object storage; every epoch's
batches are *scans* (projection = token column, window = step's token
range) served through the differential cache — so epoch 2 reads **zero**
bytes from the store, and two trainers (or a trainer + an eval job) with
overlapping windows share fragments, exactly the paper's §III-A pattern.
"""

from repro_torch.data.corpus import write_token_corpus
from repro_torch.data.packing import pack_documents
from repro_torch.data.pipeline import TokenBatchPipeline, shard_batch

__all__ = [
    "write_token_corpus",
    "pack_documents",
    "TokenBatchPipeline",
    "shard_batch",
]
