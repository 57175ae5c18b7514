"""The card's idle milliseconds under the optimizer step and the EMA
(``train.optimizer``, ``train.ema``) per train step of the traced window
(``train.step`` spans)."""

from harness import spans


def read(ctx):
    found = spans.in_window(ctx.trace, {"train.step", "train.optimizer", "train.ema"})
    if found is None:
        return None
    kept, win = found
    steps = sum(1 for s in kept if s.name == "train.step")
    if not steps:
        return None
    under = spans.idle_under(ctx.trace, [s for s in kept if s.name != "train.step"], win)
    return under / 1e3 / steps
