"""The matrix-product FLOPs of a training step's MLPs, counted from the
shapes, nothing recomputed: the forward of every MLP, and in the backward
dW of every layer and W . dh of every layer whose input needs a gradient
(every layer but the first, and the first too where the encoding has
parameters, as the hash table does, or where it is the field's geo
features, as the rgb head's is; the semantic head's input is detached)."""


def step_flops(bench, cfg: dict, rays: int) -> float:
    s = bench.work("_shapes")
    m = cfg["model"]
    pts = s.points(m, rays)
    hash_enc = m["field_type"] == "hash"
    dx = s.need_dx(m)

    def one(n, dims, first_needs_grad):
        mm = s.macs(dims)
        back = sum(mm) + sum(mm[1:]) + (mm[0] if first_needs_grad else 0)
        return 2.0 * n * (sum(mm) + back)

    total = 0.0
    for i, n in enumerate(pts["proposals"]):
        total += one(n, s.proposal(m, i)["dims"], hash_enc or dx)
    f = s.field(m)
    n = pts["field"]
    total += one(n, f["base"], hash_enc or dx) + one(n, f["rgb"], True)
    if "semantic" in f:
        total += one(n, f["semantic"], False)
    return total
