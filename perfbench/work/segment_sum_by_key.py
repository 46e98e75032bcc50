"""The by-key sum of a hash level's gradient (``csrc/segment_sum.cu``,
``nkt_segment_sum_by_key``), one call a level a step: F value rows of M
f32 cotangents, the sorted keys and the permutation read once, F rows of the
level's span of the table gradient written once; an add a value."""

SOURCE = "segment_sum"
KERNELS = ("segment_tiles_kernel", "segment_carry_kernel")


def calls(bench, cfg: dict, rays: int) -> list:
    s = bench.work("_shapes")
    F = cfg["model"]["features_per_level"]
    return [(4.0 * (F * M + 2 * M + F * span), 0.0, float(F * M))
            for M, span in s.hash_levels(cfg["model"], rays)]
