"""``train_tokens_per_s``: every token of every step the window completed,
over all the window's time on the host's clock (each step ends when its
metrics reach the host)."""


def read(run):
    if run.steps == 0 or run.window_s <= 0:
        return None
    return run.tokens / run.window_s
