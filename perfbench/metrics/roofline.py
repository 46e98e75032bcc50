"""``<kernel>_roofline[.<suffix>]``: the kernel's share of its roofline over
the traced window, in percent: the least time the card could take for the
calls of a step (``work/<kernel>.py``'s bytes, tensor FLOPs and f32
instructions a call, against ``lib/peaks.py``) over the device time a step
of the kernels it names (its csrc source, limited to ``KERNELS`` where the
module lists them). Nothing where the kernel did not run."""

from perfbench.lib import peaks


def read(ctx, name):
    if ctx.record is None or not ctx.steps:
        return None
    kernel = name.split(".", 1)[0][: -len("_roofline")]
    work = ctx.bench.work(kernel)
    names = getattr(work, "KERNELS", None)
    dev = sum(d for n, d, src, k in ctx.record.events
              if k and src == work.SOURCE and (names is None or any(x in n for x in names)))
    if dev <= 0:
        return None
    bound = sum(peaks.bound_s(*c) for c in work.calls(ctx.bench, ctx.cfg,
                                                      int(ctx.traffic["rays_per_step"])))
    return 100.0 * bound * ctx.steps / dev
