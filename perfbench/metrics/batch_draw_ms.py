"""Host milliseconds of a batch draw (``InMemoryDataManager.next_train``,
the native sampler and the gathers of the supervision), the mean over the
window's steps."""


def read(ctx, name):
    spans = ctx.spans.get("batch_draw")
    return 1e3 * sum(spans) / len(spans) if spans else None
