"""``span_host_ms.<span>``: host milliseconds a step inside one of the
program's spans (``nerf_kbs_tpu_torch.utils.profiling.span``), child spans
included: the traced window's total over its steps. The spans are on while
the profiler records, and their totals hold that session alone. Nothing
where the span did not run, or where the program has no spans."""


def read(ctx, name):
    from nerf_kbs_tpu_torch.utils import profiling

    totals = getattr(profiling, "span_totals", None)
    if totals is None or not ctx.steps:
        return None
    span = totals().get(name.split(".", 1)[1])
    return span["host_ns"] * 1e-6 / ctx.steps if span else None
