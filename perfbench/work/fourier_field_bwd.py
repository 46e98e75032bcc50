"""Kernel D (``csrc/fourier_field_bwd.cu``): the field's backward, one call a
step. Least work over n points: the whole forward recomputed, dW of every
layer, W . dh of every layer but the base chain's first; bytes: positions,
conditioning rows, the output gradient and the conditioning rows' gradient
(12 + 4 F + 16 + 4 F a point), the weights read and their gradients
written."""

SOURCE = "fourier_field_bwd"


def calls(bench, cfg: dict, rays: int) -> list:
    s = bench.work("_shapes")
    m = cfg["model"]
    f = s.field(m)
    n = s.points(m, rays)["field"]
    bm, rm = s.macs(f["base"]), s.macs(f["rgb"])
    w = s.params(f["base"]) + s.params(f["rgb"]) + 3 * f["h_freqs"]
    mac = 3 * f["h_freqs"] + sum(bm) + sum(rm) + sum(bm) + sum(rm) + sum(bm[1:]) + sum(rm)
    hidden = sum(f["base"][1:-1]) + sum(f["rgb"][1:-1])
    alu = s.alu_per_point("fourier_field_bwd", f["h_freqs"], hidden, dx=s.need_dx(m))
    per_point = 12 + 4 * f["feat_dim"] + 16 + 4 * f["feat_dim"]
    return [(n * per_point + 2 * 4 * w, 2.0 * n * mac, n * alu)]
