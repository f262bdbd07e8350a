"""``train.mfu``: the whole training step's share of the card's bf16 peak,
in %: the model FLOPs of the window's tokens (6 x parameters plus the
attention term 12 x layers x heads x head_dim x sequence, counted by the
benchmark from the configuration, no credit for recomputation) at the
traced run's ``train_tokens_per_s``, over 989 TFLOP/s."""

from portbench.harness.yardstick import BF16_FLOP_PER_S, train_flops_per_token


def read(run):
    if run.steps == 0 or run.window_s <= 0:
        return None
    per_token = train_flops_per_token(run.config, run.traffic["seq_len"])
    return 100.0 * per_token * (run.tokens / run.window_s) / BF16_FLOP_PER_S
