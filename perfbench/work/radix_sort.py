"""The radix sort of a hash level's corner slots (``csrc/segment_sum.cu``,
``nkt_radix_sort``), one call a level a step: M int32 keys read once, the
sorted keys and the permutation written once (12 M bytes), one instruction
a key."""

SOURCE = "segment_sum"
KERNELS = ("radix_hist_kernel", "radix_scan_kernel", "radix_scatter_kernel")


def calls(bench, cfg: dict, rays: int) -> list:
    s = bench.work("_shapes")
    return [(12.0 * M, 0.0, float(M)) for M, _ in s.hash_levels(cfg["model"], rays)]
