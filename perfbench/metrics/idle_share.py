"""The share of the traced window in which no operation ran on the device,
in percent: 1 minus the union of the device's busy intervals over the
window."""


def read(ctx, name):
    if ctx.record is None or ctx.record.window_us <= 0:
        return None
    return 100.0 * (1.0 - ctx.record.busy_s / (ctx.record.window_us * 1e-6))
