"""Kernel B (``csrc/fourier_field_fwd.cu``): the nerfacto field's fused
forward (base and rgb MLPs), one call a step. A call over n points reads the
positions and the per-point conditioning rows (12 + 4 F bytes a point), B
and the weights once, and writes 4 f32 outputs a point."""

SOURCE = "fourier_field_fwd"


def calls(bench, cfg: dict, rays: int) -> list:
    s = bench.work("_shapes")
    m = cfg["model"]
    f = s.field(m)
    n = s.points(m, rays)["field"]
    w = s.params(f["base"]) + s.params(f["rgb"]) + 3 * f["h_freqs"]
    mac = 3 * f["h_freqs"] + sum(s.macs(f["base"])) + sum(s.macs(f["rgb"]))
    hidden = sum(f["base"][1:-1]) + sum(f["rgb"][1:-1])
    alu = s.alu_per_point("fourier_field_fwd", f["h_freqs"], hidden)
    return [(n * (12 + 4 * f["feat_dim"] + 16) + 4 * w, 2.0 * n * mac, n * alu)]
