"""The whole step's share of the card's bf16 peak, in percent: the MLPs'
matrix-product FLOPs a step (``work/mlp_flops.py``) times the steps of the
window, over the window's seconds times 989 TFLOP/s."""

from perfbench.lib import peaks


def read(ctx, name):
    if not ctx.steps:
        return None
    flops = ctx.bench.work("mlp_flops").step_flops(ctx.bench, ctx.cfg,
                                                   int(ctx.traffic["rays_per_step"]))
    return 100.0 * flops * ctx.steps / (ctx.window["window_s"] * peaks.BF16_FLOPS)
