"""The shapes of a training step, from a configuration's model section and
the rays a step: the points each field evaluates and the widths of its MLPs,
as the work counts and the step's FLOPs need them."""


def mlp_dims(first: int, width: int, layers: int, out: int) -> list:
    return [first] + [width] * (layers - 1) + [out]


def proposal(m: dict, i: int) -> dict:
    if m["field_type"] == "fourier":
        enc = m["proposal_num_levels"] * m["proposal_fourier_features_per_level"]
    else:
        enc = m["proposal_num_levels"] * 2
    return {"h_freqs": enc // 2, "enc": enc,
            "dims": mlp_dims(enc, m["proposal_hidden_dim"], m["proposal_num_layers"], 1)}


def field(m: dict) -> dict:
    if m["field_type"] == "fourier":
        enc = m["fourier_num_levels"] * m["fourier_features_per_level"]
    else:
        enc = m["num_levels"] * m["features_per_level"]
    feat = m["sh_levels"] ** 2 + m["appearance_embedding_dim"]
    out = {"h_freqs": enc // 2, "enc": enc, "feat_dim": feat,
           "base": mlp_dims(enc, m["hidden_dim"], m["num_layers"], 1 + m["geo_feat_dim"]),
           "rgb": mlp_dims(m["geo_feat_dim"] + feat, m["hidden_dim_color"],
                           m["num_layers_color"], 3)}
    if m["use_semantic"]:
        out["semantic"] = [m["geo_feat_dim"], m["hidden_dim_semantics"],
                           m["num_semantic_classes"]]
    return out


def points(m: dict, rays: int) -> dict:
    """Points a step evaluates: each proposal round's and the field's."""
    return {"proposals": [rays * s for s in m["num_proposal_samples_per_ray"]],
            "field": rays * m["num_nerf_samples_per_ray"]}


def need_dx(m: dict) -> bool:
    """Whether the fused backwards form a position gradient."""
    return m["camera_optimizer"] != "off" or not m["stop_grad_sampling"]


def macs(dims: list) -> list:
    return [a * b for a, b in zip(dims, dims[1:])]


def params(dims: list) -> int:
    """Weights and biases of an MLP."""
    return sum(macs(dims)) + sum(dims[1:])


def hash_levels(m: dict, rays: int) -> list:
    """(corner keys M, targets span) of every level's gather a step: the
    proposal fields' levels and the field's, each level 8 corners a point,
    its slots in a span of T (a dense level that reaches past its T: up to
    its last corner, inside the table)."""
    import numpy as np

    def levels(n_levels, base, top, log2_t, n_points):
        T = 1 << log2_t
        g = float(np.exp((np.log(top) - np.log(base)) / (n_levels - 1))) if n_levels > 1 else 1.0
        out = []
        for lvl in range(n_levels):
            r1 = int(np.floor(base * g**lvl)) + 1
            span = T
            if r1**3 <= T:
                span = min(max(T, r1 * (1 + r1 + r1 * r1) + 1), (n_levels - lvl) * T)
            out.append((8 * n_points, span))
        return out

    pts = points(m, rays)
    out = []
    for i, n in enumerate(pts["proposals"]):
        out += levels(m["proposal_num_levels"], 16, m["proposal_max_res"][i],
                      m["proposal_log2_hashmap_size"], n)
    out += levels(m["num_levels"], m["base_res"], m["max_res"], m["log2_hashmap_size"],
                  pts["field"])
    return out


def alu_per_point(kernel: str, h_freqs: int, hidden_cols: int, out_dim: int = 1,
                  dx: bool = False) -> float:
    """Scalar f32 instructions a point that the function itself defines, in
    the tri basis (outside the matrix products; roundings to bf16 half an
    instruction a value):
    - the encoding, per frequency: projection 3, tri_s 5, tri_c 4, the two
      roundings 1: 13; with dx also the slopes 4, dproj 2 and dx 3: 9 more;
    - a hidden column forward: bias add, max, rounding: 2.5; backward: the
      mask's select, the bias-gradient add, the rounding of dh: 2.5;
    - the proposal chain's width-1 last layer, per hidden column: forward 2,
      backward 3, and one bias add a point;
    - a last layer wider than 1 (the base MLP alone): forward a bias add a
      column (1), backward the rounding and bias-gradient add (1.5);
    - the field's other columns: 16 base outputs' bias add and rounding
      (1.5), 16 feats' rounding (0.5), ~10 for each of 3 sigmoids; backward
      g rgb (1 - rgb) (3 each) and the rounding and bias-gradient add of the
      3 rgb and 16 base-output gradients (1.5 each)."""
    enc = 13.0 * h_freqs + (9.0 * h_freqs if dx else 0.0)
    if kernel == "fourier_mlp_fwd":
        if out_dim > 1:
            return enc + hidden_cols * 2.5 + out_dim * 1.0
        return enc + hidden_cols * (2.5 + 2) + 1
    if kernel == "fourier_mlp_bwd":
        if out_dim > 1:
            return enc + hidden_cols * (2.5 + 2.5) + out_dim * 1.5
        return enc + hidden_cols * (2.5 + 2.5 + 3) + 1
    field_fwd = enc + hidden_cols * 2.5 + 16 * 1.5 + 16 * 0.5 + 3 * 10
    if kernel == "fourier_field_fwd":
        return field_fwd
    return field_fwd + hidden_cols * 2.5 + 3 * 3 + (3 + 16) * 1.5
