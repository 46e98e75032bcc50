"""Host milliseconds of a ``Trainer.train_step`` call (the harness's span
around the call, no synchronise), the mean over the window's steps."""


def read(ctx, name):
    spans = ctx.spans.get("train_step")
    return 1e3 * sum(spans) / len(spans) if spans else None
