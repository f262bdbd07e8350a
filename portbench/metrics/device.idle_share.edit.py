"""``device.idle_share.edit``: the share of the traced window in which no
operation ran on the card, in %, from ``torch.profiler``'s device events."""

from portbench.harness.trace import idle_share


def read(run):
    return idle_share(run.trace)
