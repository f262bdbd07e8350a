"""``store_s_per_edit``: the simulated object-store seconds each edit of the
window pays, the paper's Table I latency, from the store's exact GET and
byte counts over whole sessions or rounds (``harness.yardstick.store_seconds``)."""

from portbench.harness.yardstick import store_seconds


def read(run):
    if not run.edits:
        return None
    return store_seconds(run.store_gets, run.store_bytes) / len(run.edits)
