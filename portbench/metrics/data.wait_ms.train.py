"""``data.wait_ms.train``: the milliseconds each window step waited for its
batch (``TokenBatchPipeline`` through the scan planner, placed on the
card), the benchmark's host timer around each fetch, over the steps."""


def read(run):
    if not run.data_wait_s:
        return None
    return 1e3 * sum(run.data_wait_s) / len(run.data_wait_s)
