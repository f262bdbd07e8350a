"""``data.batch_ms.train``: the milliseconds the prefetch thread took to
build a batch (its scan through the differential cache and the batch's
assembly), the program's ``data.batch`` spans begun in the window, their
mean."""

from portbench.harness.data_spans import window_spans


def read(run):
    _waits, batches = window_spans(run)
    if not batches:
        return None
    return sum(sp.t1_ns - sp.t0_ns for sp in batches) / 1e6 / len(batches)
