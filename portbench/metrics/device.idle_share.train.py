"""``device.idle_share.train``: the share of the traced steps in which no
operation ran on the card, in %, from ``torch.profiler``'s device events."""

from portbench.harness.trace import idle_share


def read(run):
    return idle_share(run.trace)
