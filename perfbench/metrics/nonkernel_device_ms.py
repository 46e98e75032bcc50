"""Device milliseconds a step of every operation not built from the port's
``csrc/`` (PyTorch's kernels, copies and memsets): the models', samplers',
renderer's, losses' and optimizer's glue."""


def read(ctx, name):
    if ctx.record is None or not ctx.steps:
        return None
    s = sum(d for _, d, src, _ in ctx.record.events if src is None)
    return 1e3 * s / ctx.steps
