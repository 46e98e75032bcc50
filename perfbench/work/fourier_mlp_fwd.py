"""Kernel A (``csrc/fourier_mlp_fwd.cu``): the proposal fields' fused
Fourier MLP forward, one call a proposal round. A call over n points reads
the positions (12 bytes a point), B and the weights once, and writes one f32
output a point; its tensor-core FLOPs are 2 n (3 H + the chain's MACs)."""

SOURCE = "fourier_mlp_fwd"


def calls(bench, cfg: dict, rays: int) -> list:
    """(bytes, tensor FLOPs, f32 instructions) of each call a step."""
    s = bench.work("_shapes")
    m = cfg["model"]
    out = []
    for i, n in enumerate(s.points(m, rays)["proposals"]):
        p = s.proposal(m, i)
        w = s.params(p["dims"]) + 3 * p["h_freqs"]
        mac = 3 * p["h_freqs"] + sum(s.macs(p["dims"]))
        alu = s.alu_per_point("fourier_mlp_fwd", p["h_freqs"], sum(p["dims"][1:-1]))
        out.append((n * (12 + 4) + 4 * w, 2.0 * n * mac, n * alu))
    return out
