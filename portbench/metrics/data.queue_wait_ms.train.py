"""``data.queue_wait_ms.train``: the milliseconds each window step's
training loop waited inside ``TokenBatchPipeline`` for its batch, the
program's ``data.wait`` spans (the prefetch queue's ``get``), over the
steps.  ``data.wait_ms.train`` times the same fetch from outside, with
``shard_batch``'s placement on the card."""

from portbench.harness.data_spans import window_spans


def read(run):
    waits, _batches = window_spans(run)
    if not waits:
        return None
    return sum(sp.t1_ns - sp.t0_ns for sp in waits) / 1e6 / len(waits)
