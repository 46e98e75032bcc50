"""Device milliseconds a step of the hash levels' backward kernels: the
radix sorts and the by-key sums (the kernels that ``work/radix_sort.py`` and
``work/segment_sum_by_key.py`` name); nothing where none ran."""


def read(ctx, name):
    if ctx.record is None or not ctx.steps:
        return None
    names = set(ctx.bench.work("radix_sort").KERNELS) | set(
        ctx.bench.work("segment_sum_by_key").KERNELS)
    s = sum(d for n, d, src, _ in ctx.record.events
            if src is not None and any(k in n for k in names))
    return 1e3 * s / ctx.steps if s > 0 else None
