"""``fragment_union.roofline``: the share of its memory-bound roofline that
the UNION kernel reaches over the traced window, in %: the bytes every
UNION that copied must move (each input byte read once, each output byte
written once, counted by the benchmark from the runs' shapes) over the
card's 3.35 TB/s, divided by the kernel's device time in the trace.
Nothing when no UNION copied."""

from portbench.harness.trace import kernel_seconds
from portbench.harness.yardstick import HBM_BYTES_PER_S


def read(run):
    seconds = kernel_seconds(run.trace, "fragment_union")
    if seconds <= 0 or run.union_bytes <= 0:
        return None
    return 100.0 * (run.union_bytes / HBM_BYTES_PER_S) / seconds
