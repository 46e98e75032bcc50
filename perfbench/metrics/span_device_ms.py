"""``span_device_ms.<span>``: stream milliseconds a step inside one of the
program's spans: the time of its CUDA event pairs (from the stream reaching
the span's first work to finishing its last, busy and idle alike, so where
the host paces the stream it reads the host's time) over the traced window's
steps. Nothing off CUDA, where the span did not run, or where the program
has no spans."""


def read(ctx, name):
    from nerf_kbs_tpu_torch.utils import profiling

    totals = getattr(profiling, "span_totals", None)
    if totals is None or not ctx.steps:
        return None
    span = totals().get(name.split(".", 1)[1])
    return span["device_ms"] / ctx.steps if span and "device_ms" in span else None
