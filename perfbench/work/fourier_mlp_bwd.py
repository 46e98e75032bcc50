"""Kernel C (``csrc/fourier_mlp_bwd.cu``): the proposal fields' backward,
one call a proposal round. Least work of a call over n points: the
recompute of the hidden layers, dW of every layer and W . dh of every layer
but the first; bytes: the positions and the output gradient (16 a point),
the weights read and their gradients written."""

SOURCE = "fourier_mlp_bwd"


def calls(bench, cfg: dict, rays: int) -> list:
    s = bench.work("_shapes")
    m = cfg["model"]
    out = []
    for i, n in enumerate(s.points(m, rays)["proposals"]):
        p = s.proposal(m, i)
        pm = s.macs(p["dims"])
        w = s.params(p["dims"]) + 3 * p["h_freqs"]
        mac = 3 * p["h_freqs"] + sum(pm[:-1]) + sum(pm) + sum(pm[1:])
        alu = s.alu_per_point("fourier_mlp_bwd", p["h_freqs"], sum(p["dims"][1:-1]),
                              dx=s.need_dx(m))
        out.append((n * (12 + 4) + 2 * 4 * w, 2.0 * n * mac, n * alu))
    return out
