"""The plain reference of a nerfacto training step, in float32 with TF32 off.

A frozen, self-contained copy of the mathematics of the port's training step
(ray generation, the near/far collider, the proposal sampler, the Fourier
and hash fields and their MLPs, volume rendering, the losses, the per-group
global-norm clip and Adam), written point-major with plain PyTorch
operations and autograd. It imports nothing of the program: what it needs
of the configuration comes from the configuration file under
``perfbench/configs`` (its "model" and "optimizers" sections), and its
inputs (the camera arrays of the scene, the drawn batches, the sampler
jitter and the initial weights, which ``init_params`` makes) are handed to
it by the harness, which hands the same to the program.

Arithmetic is float32 with TF32 off. ``Rounding`` rounds the operands of
the MLPs' products where the configuration's compute dtype says (bf16
mixed precision: products of bf16 values accumulated in f32, as the
port's plain versions define it); the control (``Rounding("fp8")``)
rounds the same operands to float8.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# ---------------------------------------------------------------------------
# rounding points
# ---------------------------------------------------------------------------


class _Fp8(torch.autograd.Function):
    """Rounding to float8 with a per-tensor scale (the tensor's absolute
    maximum onto the format's largest value): e4m3 in the forward, and the
    gradient that comes back through the same point to e5m2."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


def _fp8(t, dtype, top: float):
    scale = torch.clamp_min(t.abs().amax(), 1e-30) / top
    return (t / scale).to(dtype).float() * scale


class Rounding:
    """The points where the configuration's mixed precision rounds: every
    MLP input, weight and hidden activation (products then accumulate in
    f32, biases add in f32). ``kind``: "float32" (no rounding), "bfloat16"
    (to bf16 there; autograd rounds the gradient through each point to
    bf16 too, as the port's plain MLPs do), or "fp8" (the control: e4m3
    with a per-tensor scale, gradients e5m2)."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "bfloat16", "fp8"):
            raise ValueError(f"unknown rounding {kind!r}")
        self.kind = kind

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "bfloat16":
            return t.to(torch.bfloat16).float()
        if self.kind == "fp8":
            return _Fp8.apply(t)
        return t


# ---------------------------------------------------------------------------
# configuration helpers
# ---------------------------------------------------------------------------


def fourier_resolutions(num_levels: int, base: float, top: float) -> list:
    if num_levels == 1:
        return [float(base)]
    g = float(np.exp((np.log(top) - np.log(base)) / (num_levels - 1)))
    return [base * g**lvl for lvl in range(num_levels)]


def hash_resolutions(num_levels: int, base: int, top: int) -> list:
    if num_levels == 1:
        return [base]
    g = float(np.exp((np.log(top) - np.log(base)) / (num_levels - 1)))
    return [int(np.floor(base * g**lvl)) for lvl in range(num_levels)]


def field_spec(m: dict) -> dict:
    """The nerfacto field's encoding and MLP widths from the model section."""
    if m["field_type"] == "fourier":
        enc = {"kind": "fourier", "levels": m["fourier_num_levels"],
               "per_level": m["fourier_features_per_level"], "basis": m["fourier_basis"],
               "res": fourier_resolutions(m["fourier_num_levels"], m["base_res"], m["max_res"])}
        enc_dim = m["fourier_num_levels"] * m["fourier_features_per_level"]
    else:
        enc = {"kind": "hash", "levels": m["num_levels"], "per_level": m["features_per_level"],
               "log2_T": m["log2_hashmap_size"],
               "res": hash_resolutions(m["num_levels"], m["base_res"], m["max_res"])}
        enc_dim = m["num_levels"] * m["features_per_level"]
    geo = m["geo_feat_dim"]
    app = m["appearance_embedding_dim"]
    spec = {
        "enc": enc,
        "base": [enc_dim] + [m["hidden_dim"]] * (m["num_layers"] - 1) + [1 + geo],
        "rgb": [geo + m["sh_levels"] ** 2 + app] + [m["hidden_dim_color"]]
        * (m["num_layers_color"] - 1) + [3],
        "app": app,
    }
    if m["use_semantic"]:
        spec["semantic"] = [geo, m["hidden_dim_semantics"], m["num_semantic_classes"]]
    return spec


def proposal_spec(m: dict, i: int) -> dict:
    res_top = m["proposal_max_res"][i]
    if m["field_type"] == "fourier":
        enc = {"kind": "fourier", "levels": m["proposal_num_levels"],
               "per_level": m["proposal_fourier_features_per_level"],
               "basis": m["proposal_fourier_basis"],
               "res": fourier_resolutions(m["proposal_num_levels"], 16, res_top)}
        enc_dim = m["proposal_num_levels"] * m["proposal_fourier_features_per_level"]
    else:
        enc = {"kind": "hash", "levels": m["proposal_num_levels"], "per_level": 2,
               "log2_T": m["proposal_log2_hashmap_size"],
               "res": hash_resolutions(m["proposal_num_levels"], 16, res_top)}
        enc_dim = m["proposal_num_levels"] * 2
    return {"enc": enc,
            "mlp": [enc_dim] + [m["proposal_hidden_dim"]] * (m["proposal_num_layers"] - 1) + [1]}


# ---------------------------------------------------------------------------
# initial weights, made on the device from the seed
# ---------------------------------------------------------------------------


def _leaf_plan(m: dict, num_images: int) -> list:
    """(path, shape, rule) of every parameter leaf, in a fixed order. The
    paths are those of the port's parameter tree, joined by '/'."""
    plan = []

    def enc_leaves(prefix, enc):
        if enc["kind"] == "fourier":
            plan.append((f"{prefix}/fourier_B", (3, enc["levels"] * enc["per_level"] // 2),
                         ("fourier", enc)))
        else:
            n = enc["per_level"] * enc["levels"] * (1 << enc["log2_T"])
            plan.append((f"{prefix}/hash_table", (n,), ("uniform", 1e-4)))

    def mlp_leaves(prefix, dims):
        for i in range(len(dims) - 1):
            plan.append((f"{prefix}/w/{i}", (dims[i], dims[i + 1]),
                         ("uniform", (6.0 / dims[i]) ** 0.5)))
            plan.append((f"{prefix}/b/{i}", (dims[i + 1],), ("zeros", None)))

    f = field_spec(m)
    enc_leaves("fields", f["enc"])
    mlp_leaves("fields/base_mlp", f["base"])
    mlp_leaves("fields/rgb_mlp", f["rgb"])
    if f["app"] > 0:
        plan.append(("fields/appearance_emb", (num_images, f["app"]), ("normal", 0.1)))
    if "semantic" in f:
        mlp_leaves("fields/semantic_mlp", f["semantic"])
    for i in range(m["num_proposal_iterations"]):
        p = proposal_spec(m, i)
        enc_leaves(f"proposal_networks/{i}", p["enc"])
        mlp_leaves(f"proposal_networks/{i}/mlp", p["mlp"])
    return plan


def init_params(m: dict, num_images: int, seed: int, device) -> dict:
    """Every leaf of the model's parameters, {path: tensor}, drawn on
    ``device`` from ``seed`` in two calls (one uniform, one normal buffer):
    MLP weights uniform in +-sqrt(6 / fan_in) and zero biases, hash tables
    uniform in +-1e-4, Fourier frequency matrices as random unit directions
    times each level's resolution, appearance rows 0.1 N(0, 1)."""
    plan = _leaf_plan(m, num_images)
    sizes = {"uniform": 0, "normal": 0}
    for _, shape, (rule, _) in plan:
        n = int(np.prod(shape))
        if rule == "uniform":
            sizes["uniform"] += n
        elif rule in ("normal", "fourier"):
            sizes["normal"] += n
    g = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(sizes["uniform"], generator=g, device=device)
    z = torch.randn(sizes["normal"], generator=g, device=device)
    out, iu, iz = {}, 0, 0
    for path, shape, (rule, arg) in plan:
        n = int(np.prod(shape))
        if rule == "uniform":
            out[path] = ((u[iu:iu + n] * 2.0 - 1.0) * arg).reshape(shape)
            iu += n
        elif rule == "zeros":
            out[path] = torch.zeros(shape, device=device)
        elif rule == "normal":
            out[path] = (z[iz:iz + n] * arg).reshape(shape)
            iz += n
        else:  # fourier: unit directions (per column) times the level's resolution
            d = z[iz:iz + n].reshape(shape)
            iz += n
            d = d / torch.linalg.vector_norm(d, dim=0, keepdim=True)
            half = arg["per_level"] // 2
            scales = torch.tensor(arg["res"], dtype=torch.float32,
                                  device=device).repeat_interleave(half)
            out[path] = d * scales[None, :]
    return out


def trainable(path: str) -> bool:
    """The frequency matrices are frozen; every other leaf trains."""
    return not path.endswith("fourier_B")


def group_of(path: str) -> str:
    return path.split("/", 1)[0]


# ---------------------------------------------------------------------------
# rays
# ---------------------------------------------------------------------------


def generate_rays(cams: dict, ray_indices: torch.Tensor) -> dict:
    """Pinhole rays through pixel centres, OpenGL camera axes: origins,
    unit directions and |direction| before normalising (R, 1)."""
    idx = ray_indices[:, 0].long()
    px = ray_indices[:, 2].float() + 0.5
    py = ray_indices[:, 1].float() + 0.5
    x = (px - cams["cx"][idx]) / cams["fx"][idx]
    y = (py - cams["cy"][idx]) / cams["fy"][idx]
    c2w = cams["c2w"][idx]
    d = c2w[:, :, 0] * x[:, None] - c2w[:, :, 1] * y[:, None] - c2w[:, :, 2]
    norm = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    return {"origins": c2w[:, :, 3], "directions": d / norm, "directions_norm": norm,
            "camera": idx}


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def spacing_to_euclidean(s, nears, fars, kind: str):
    if kind == "uniform":
        return nears + s * (fars - nears)
    if kind == "lindisp":
        return 1.0 / (1.0 / nears * (1.0 - s) + 1.0 / fars * s)
    if kind == "piecewise":
        mid = nears + 1.0
        lin = nears + s * 2.0
        inv = 1.0 / (1.0 / mid * (2.0 - 2.0 * s) + 1.0 / fars * (2.0 * s - 1.0))
        return torch.where(s < 0.5, lin, inv)
    raise ValueError(kind)


def make_samples(s_edges, nears, fars, spacing):
    """Bins from edges (R, S + 1) in the spacing domain."""
    return {"s_edges": s_edges,
            "t_edges": spacing_to_euclidean(s_edges, nears, fars, spacing)}


def midpoints(samples):
    t = samples["t_edges"]
    return 0.5 * (t[:, :-1] + t[:, 1:])


def deltas(samples):
    t = samples["t_edges"]
    return t[:, 1:] - t[:, :-1]


def uniform_edges(R: int, n: int, jitter, device):
    edges = torch.linspace(0.0, 1.0, n + 1, device=device).expand(R, n + 1)
    centers = (edges[:, :-1] + edges[:, 1:]) / 2.0
    lower = torch.cat([edges[:, :1], centers], dim=-1)
    upper = torch.cat([centers, edges[:, -1:]], dim=-1)
    return lower + (upper - lower) * jitter


class _Bracket(torch.autograd.Function):
    """(cdf_b, cdf_{b+1}, edge_b, edge_{b+1}) with b(q) = max{s : cdf_s <=
    u_q}, clamped into the last bin; cotangents go to cdf and edges at b and
    b + 1; u carries none."""

    @staticmethod
    def forward(ctx, cdf, edges, u):
        b = torch.clamp_max(torch.searchsorted(cdf, u, right=True) - 1, cdf.shape[1] - 2)
        ctx.save_for_backward(b)
        ctx.n = cdf.shape[1]
        return (torch.gather(cdf, 1, b), torch.gather(cdf, 1, b + 1),
                torch.gather(edges, 1, b), torch.gather(edges, 1, b + 1))

    @staticmethod
    def backward(ctx, g_clo, g_chi, g_elo, g_ehi):
        (b,) = ctx.saved_tensors
        d_cdf = g_clo.new_zeros(b.shape[0], ctx.n)
        d_cdf.scatter_add_(1, b, g_clo).scatter_add_(1, b + 1, g_chi)
        d_edges = g_elo.new_zeros(b.shape[0], ctx.n)
        d_edges.scatter_add_(1, b, g_elo).scatter_add_(1, b + 1, g_ehi)
        return d_cdf, d_edges, None


class _RunningMax(torch.autograd.Function):
    """The running maximum along rows; each cotangent goes to the index of
    its position's running maximum."""

    @staticmethod
    def forward(ctx, x):
        values, idx = torch.cummax(x, dim=1)
        ctx.save_for_backward(idx)
        return values

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return g.new_zeros(g.shape).scatter_add_(1, idx, g)


def pdf_edges(samples, weights, n: int, rand, histogram_padding: float = 0.01):
    """Inverse-CDF resampling of n bins from per-bin weights, at evenly
    spaced quantiles offset by ``rand`` (R, 1) / (n + 1)."""
    R = weights.shape[0]
    dev = weights.device
    w = weights + histogram_padding
    pdf = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.clamp_max(torch.cumsum(pdf, dim=-1), 1.0)
    cdf = torch.cat([torch.zeros(R, 1, device=dev), cdf[:, :-1], torch.ones(R, 1, device=dev)],
                    dim=-1)
    bins = n + 1
    u = torch.linspace(0.0, 1.0 - 1.0 / bins, bins, device=dev)[None, :] + rand / bins
    u = u.expand(R, bins).contiguous()
    c_lo, c_hi, e_lo, e_hi = _Bracket.apply(cdf, samples["s_edges"], u)
    frac = torch.clamp((u - c_lo) / torch.clamp_min(c_hi - c_lo, 1e-10), 0.0, 1.0)
    return _RunningMax.apply(e_lo + frac * (e_hi - e_lo))


def render_weights(density, dts):
    tau = density * dts
    alpha = 1.0 - torch.exp(-tau)
    trans = torch.exp(-(torch.cumsum(tau, dim=-1) - tau))
    return alpha * trans


# ---------------------------------------------------------------------------
# fields
# ---------------------------------------------------------------------------


class _TruncExp(torch.autograd.Function):
    """exp with its input clamped at 11; gradient g exp(clip(x, -15, 15))."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(torch.clamp_max(x, 11.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def contract(x):
    """The L-inf scene contraction, then [-2, 2] -> [0, 1]."""
    mag = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-9)
    return (torch.where(mag <= 1.0, x, (2.0 - 1.0 / mag) * (x / mag)) + 2.0) / 4.0


def tri_s(u):
    f = u + 0.75
    f = f - torch.floor(f)
    return 4.0 * torch.abs(f - 0.5) - 1.0


def tri_c(u):
    f = u - torch.floor(u)
    return 4.0 * torch.abs(f - 0.5) - 1.0


def fourier_window(enc: dict, progress: float, device):
    half = enc["per_level"] // 2
    lvl = torch.arange(enc["levels"], dtype=torch.float32, device=device).repeat_interleave(half)
    x = torch.clamp(float(progress) * enc["levels"] - lvl, 0.0, 1.0)
    return 0.5 * (1.0 - torch.cos(math.pi * x))


def fourier_encode(B, x, enc: dict, window):
    proj = x @ B.detach()
    if enc["basis"] == "tri":
        s, c = tri_s(proj), tri_c(proj)
    else:
        proj = proj * (2.0 * math.pi)
        s, c = torch.sin(proj), torch.cos(proj)
    if window is not None:
        s, c = s * window, c * window
    return torch.cat([s, c], dim=-1)


_PRIMES = (1, 2654435761, 805459861)


def hash_encode(table, x, enc: dict):
    """Trilinear interpolation of 8 corners a level, levels concatenated
    level-major; the table is feature-major (F, L * T) flat. Points are
    clamped into [0, 1] as jnp.clip clamps (a tie splits the gradient)."""
    L, F, T = enc["levels"], enc["per_level"], 1 << enc["log2_T"]
    p = torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))
    rows = table.view(F, L * T)
    feats = []
    offsets = torch.tensor([[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)],
                           device=x.device)
    for lvl, res in enumerate(enc["res"]):
        ps = p * res
        fl = torch.floor(ps)
        frac = ps - fl
        corner = fl.to(torch.int64)[:, None, :] + offsets[None]  # (N, 8, 3)
        wsel = torch.where(offsets[None].bool(), frac[:, None, :], 1.0 - frac[:, None, :])
        w = wsel[..., 0] * wsel[..., 1] * wsel[..., 2]  # (N, 8)
        r1 = res + 1
        if r1**3 <= T:
            idx = corner[..., 0] + r1 * (corner[..., 1] + r1 * corner[..., 2])
            if lvl * T + r1 * (1 + r1 + r1 * r1) > L * T - 1:
                idx = idx.clamp_max(L * T - 1 - lvl * T)
        else:
            idx = ((corner[..., 0] * _PRIMES[0]) ^ (corner[..., 1] * _PRIMES[1])
                   ^ (corner[..., 2] * _PRIMES[2])) & (T - 1)
        g = rows.index_select(1, (idx + lvl * T).reshape(-1)).reshape(F, -1, 8)
        feats.append(torch.sum(g * w[None], dim=-1).t())  # (N, F)
    return torch.cat(feats, dim=-1)


def mlp(params: dict, prefix: str, h, n_layers: int, rnd: Rounding):
    """relu MLP, point-major, with the program's rounding points."""
    h = rnd(h)
    for i in range(n_layers):
        h = h @ rnd(params[f"{prefix}/w/{i}"]) + params[f"{prefix}/b/{i}"]
        if i < n_layers - 1:
            h = rnd(torch.relu(h))
    return h


def encode(params, prefix, enc, x, window):
    if enc["kind"] == "fourier":
        return fourier_encode(params[f"{prefix}/fourier_B"], x, enc, window)
    return hash_encode(params[f"{prefix}/hash_table"], x, enc)


def sh_encoding(d):
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x,
        1.0925484305920792 * xy, -1.0925484305920792 * yz,
        0.94617469575755997 * zz - 0.31539156525251999, -1.0925484305920792 * xz,
        0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy), 2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz), 0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz), 1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy),
    ], dim=-1)


# ---------------------------------------------------------------------------
# the forward and the losses
# ---------------------------------------------------------------------------


def forward(params: dict, m: dict, rays: dict, step: int, jitters, rnd: Rounding) -> dict:
    """A training forward over rays (R,): the proposal chain, the field and
    the composite."""
    origins, dirs = rays["origins"], rays["directions"]
    R, dev = origins.shape[0], origins.device
    nears = torch.full((R, 1), m["near_plane"], device=dev)
    fars = torch.full((R, 1), m["far_plane"], device=dev)
    spacing = m["proposal_initial_sampler"]
    f = field_spec(m)
    if m["field_type"] == "fourier":
        progress = (min(max(step / m["fourier_anneal_steps"], 0.0), 1.0)
                    if m["fourier_anneal_steps"] > 0 else 1.0)
    if m["use_proposal_weight_anneal"]:
        frac = min(max(step / m["proposal_weights_anneal_max_num_iters"], 0.0), 1.0)
        slope = m["proposal_weights_anneal_slope"]
        anneal = (slope * frac) / ((slope - 1.0) * frac + 1.0)
    else:
        anneal = 1.0

    def points(samples):
        x = origins[:, None, :] + dirs[:, None, :] * midpoints(samples)[..., None]
        return contract(x.reshape(-1, 3))

    n_rounds = m["num_proposal_iterations"]
    samples = make_samples(uniform_edges(R, m["num_proposal_samples_per_ray"][0], jitters[0], dev),
                           nears, fars, spacing)
    history = []
    for i in range(n_rounds):
        p = proposal_spec(m, i)
        window = (fourier_window(p["enc"], progress, dev) if p["enc"]["kind"] == "fourier"
                  else None)
        prefix = f"proposal_networks/{i}"
        h = mlp(params, f"{prefix}/mlp", encode(params, prefix, p["enc"], points(samples), window),
                len(p["mlp"]) - 1, rnd)
        density = _TruncExp.apply(h[:, 0] - 1.0).reshape(R, -1)
        weights = render_weights(density, deltas(samples))
        history.append((samples, weights))
        n_next = (m["num_proposal_samples_per_ray"][i + 1] if i + 1 < n_rounds
                  else m["num_nerf_samples_per_ray"])
        w_in = torch.pow(torch.clamp_min(weights, 1e-10), anneal)
        src = samples
        if m["stop_grad_sampling"]:
            w_in = w_in.detach()
            src = {k: v.detach() for k, v in samples.items()}
        samples = make_samples(pdf_edges(src, w_in, n_next, jitters[i + 1]), nears, fars, spacing)

    window = fourier_window(f["enc"], progress, dev) if f["enc"]["kind"] == "fourier" else None
    S = m["num_nerf_samples_per_ray"]
    h = mlp(params, "fields/base_mlp", encode(params, "fields", f["enc"], points(samples), window),
            len(f["base"]) - 1, rnd)
    density = _TruncExp.apply(h[:, 0] - 1.0).reshape(R, S)
    geo = h[:, 1:]
    cond = [sh_encoding(dirs)]
    if f["app"] > 0:
        cond.append(params["fields/appearance_emb"][rays["camera"]])
    cond = torch.cat(cond, dim=-1)
    rgb_in = torch.cat([geo, cond[:, None, :].expand(R, S, -1).reshape(R * S, -1)], dim=-1)
    rgb = torch.sigmoid(mlp(params, "fields/rgb_mlp", rgb_in, len(f["rgb"]) - 1, rnd))
    rgb = rgb.reshape(R, S, 3)
    weights = render_weights(density, deltas(samples))
    acc = torch.sum(weights, dim=-1, keepdim=True)
    comp = torch.sum(weights[..., None] * rgb, dim=1)
    if m["background_color"] != "last_sample":
        raise NotImplementedError(m["background_color"])
    out = {"rgb": comp + rgb[:, -1, :] * (1.0 - acc), "weights": weights, "samples": samples,
           "history": history, "accumulation": acc}
    mids = midpoints(samples)
    cum = torch.cumsum(weights, dim=-1)
    out["depth"] = torch.amin(torch.where(cum >= 0.5, mids, mids[:, -1:]), dim=-1, keepdim=True)
    if "semantic" in f:
        sem = mlp(params, "fields/semantic_mlp", geo.detach(), 2, rnd).reshape(R, S, -1)
        w_sem = weights if m["pass_semantic_gradients"] else weights.detach()
        out["semantics"] = torch.sum(w_sem[..., None] * sem, dim=1)
    return out


class _OuterBounds(torch.autograd.Function):
    """(cw at the last env edge <= t0, clamped at 0; cw at the first env
    edge > t1, at most the total): the cotangents go to the selected cw
    entries, the upper one to the last entry where no edge lies past t1."""

    @staticmethod
    def forward(ctx, t_env, cw, t0, t1):
        n = t_env.shape[1]
        i_lo = torch.searchsorted(t_env, t0.contiguous(), right=True)
        i_hi = torch.searchsorted(t_env, t1.contiguous(), right=True)
        lo = torch.gather(cw, 1, torch.clamp_min(i_lo - 1, 0))
        lo = torch.where(i_lo > 0, lo, torch.zeros_like(lo))
        hi = torch.gather(cw, 1, torch.clamp_max(i_hi, n - 1))
        ctx.save_for_backward(i_lo, i_hi)
        ctx.n = n
        return torch.clamp_min(lo, 0.0), torch.minimum(hi, cw[:, -1:])

    @staticmethod
    def backward(ctx, g_lo, g_hi):
        i_lo, i_hi = ctx.saved_tensors
        d = g_lo.new_zeros(g_lo.shape[0], ctx.n)
        d.scatter_add_(1, torch.clamp_min(i_lo - 1, 0), g_lo * (i_lo > 0).to(g_lo.dtype))
        d.scatter_add_(1, torch.clamp_max(i_hi, ctx.n - 1), g_hi)
        return None, d, None, None


def interlevel_loss(samples, weights, history, n: int):
    t_final = samples["s_edges"][:n].detach()
    w_final = weights[:n].detach()
    loss = 0.0
    for ps, pw in history:
        pw = pw[:n]
        cw = torch.cat([torch.zeros_like(pw[:, :1]), torch.cumsum(pw, dim=-1)], dim=-1)
        before, after = _OuterBounds.apply(ps["s_edges"][:n].detach(), cw,
                                           t_final[:, :-1], t_final[:, 1:])
        w_outer = after - before
        loss = loss + torch.mean(torch.clamp_min(w_final - w_outer, 0.0) ** 2 / (w_final + 1e-7))
    return loss


def distortion_loss(samples, weights):
    s = samples["s_edges"]
    mid = 0.5 * (s[:, :-1] + s[:, 1:])
    interval = s[:, 1:] - s[:, :-1]
    loss_uni = torch.sum(weights**2 * interval, dim=-1) / 3.0
    w_cum = torch.cumsum(weights, dim=-1) - weights
    wm_cum = torch.cumsum(weights * mid, dim=-1) - weights * mid
    loss_bi = 2.0 * torch.sum(weights * (mid * w_cum - wm_cum), dim=-1)
    return torch.mean(loss_uni + loss_bi)


def masked_mean(values, weights, per_row: int = 1):
    return torch.sum(weights * values) / torch.clamp_min(torch.sum(weights) * per_row, 1.0)


def monodepth_loss(pred, gt, mask):
    pred, gt, m = pred.reshape(-1), gt.reshape(-1), mask.reshape(-1)
    a00, a01, a11 = torch.sum(m * pred * pred), torch.sum(m * pred), torch.sum(m)
    b0, b1 = torch.sum(m * pred * gt), torch.sum(m * gt)
    det = a00 * a11 - a01 * a01
    if float(det.detach()) <= 1e-9:
        scale = shift = det * 0.0
    else:
        scale = (a11 * b0 - a01 * b1) / det
        shift = (-a01 * b0 + a00 * b1) / det
    return masked_mean((scale * pred + shift - gt) ** 2, m)


def loss(m: dict, out: dict, batch: dict, rays: dict, semantic_nerfw: bool) -> torch.Tensor:
    """The training loss of nerfacto (``semantic_nerfw`` False) or of
    semantic NeRF-W: rgb (masked where the model uses the mask), interlevel
    (on the first ``interlevel_ray_fraction`` of the rays), distortion,
    semantics and the scale-and-shift-invariant depth term."""
    gt, pred = batch["image"], out["rgb"]
    R = gt.shape[0]
    if m["use_mask"] and "mask" in batch:
        total = masked_mean((pred - gt) ** 2, batch["mask"], per_row=3)
    else:
        total = torch.mean((pred - gt) ** 2)
    if m["interlevel_loss_mult"] > 0 or semantic_nerfw:
        frac = m["interlevel_ray_fraction"]
        n = R if frac >= 1.0 else max(1, int(R * frac))
        total = total + m["interlevel_loss_mult"] * interlevel_loss(
            out["samples"], out["weights"], out["history"], n)
    if m["distortion_loss_mult"] > 0 or semantic_nerfw:
        total = total + m["distortion_loss_mult"] * distortion_loss(out["samples"], out["weights"])
    if m["use_semantic"] and "semantics_label" in batch:
        logp = torch.log_softmax(out["semantics"], dim=-1)
        ce = -torch.mean(torch.gather(logp, 1, batch["semantics_label"].long()[:, None]))
        total = total + m["semantic_loss_weight"] * ce
    if m["use_depth"] and "depth_image" in batch:
        gt_depth = batch["depth_image"]
        if not m["is_euclidean_depth"]:
            gt_depth = gt_depth * rays["directions_norm"]
        mask = batch.get("mask", torch.ones_like(gt_depth))
        total = total + m["mono_depth_loss_mult"] * monodepth_loss(out["depth"], gt_depth, mask)
    return total


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def learning_rate(opt: dict, count: int) -> float:
    if opt.get("lr_final") is None:
        return opt["lr"]
    rate = opt["lr_final"] / opt["lr"]
    lr = opt["lr"] * rate ** (count / opt["max_steps"])
    return max(lr, opt["lr_final"]) if rate < 1.0 else min(lr, opt["lr_final"])


class Adam:
    """Per group: the global-norm clip (when ``max_norm`` is set), then Adam
    with eps outside the root, at the group's learning rate for its count."""

    def __init__(self, optimizers: dict, params: dict):
        self.cfg = optimizers
        self.mu = {k: torch.zeros_like(v) for k, v in params.items() if trainable(k)}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items() if trainable(k)}
        self.count = 0

    def clipped(self, grads: dict) -> dict:
        out = {}
        for g, opt in self.cfg.items():
            keys = [k for k in grads if group_of(k) == g]
            if opt.get("max_norm") is not None and keys:
                norm = torch.linalg.vector_norm(
                    torch.stack([torch.linalg.vector_norm(grads[k]) for k in keys]))
                scale = opt["max_norm"] / torch.clamp_min(norm, opt["max_norm"])
                out.update({k: grads[k] * scale for k in keys})
            else:
                out.update({k: grads[k] for k in keys})
        return out

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        t = self.count + 1
        c1, c2 = 1.0 - 0.9**t, 1.0 - 0.999**t
        for k, g in grads.items():
            opt = self.cfg[group_of(k)]
            lr = learning_rate(opt, self.count)
            self.mu[k].mul_(0.9).add_(g, alpha=0.1)
            self.nu[k].mul_(0.999).addcmul_(g, g, value=0.001)
            denom = (self.nu[k] / c2).sqrt_().add_(opt["eps"])
            params[k].addcdiv_(self.mu[k], denom, value=-lr / c1)
        self.count += 1


# ---------------------------------------------------------------------------
# training steps
# ---------------------------------------------------------------------------


def train_steps(init: dict, m: dict, optimizers: dict, cams: dict, batches: list, jitters: list,
                start_step: int, semantic_nerfw: bool, rnd: Rounding | None = None) -> dict:
    """Steps ``start_step``, ``start_step + 1``, ... from the weights
    ``init`` on the given batches (dicts of tensors) and jitters: {'losses':
    each step's total loss, 'grads': the first step's gradients as the
    optimizer takes them (after the clip), 'params': the weights after the
    last step}. TF32 is off for the duration."""
    rnd = Rounding() if rnd is None else rnd
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        params = {k: v.detach().clone().requires_grad_(trainable(k)) for k, v in init.items()}
        opt = Adam(optimizers, params)
        losses, first = [], None
        for i, (batch, jit) in enumerate(zip(batches, jitters)):
            rays = generate_rays(cams, batch["ray_indices"])
            out = forward(params, m, rays, start_step + i, jit, rnd)
            total = loss(m, out, batch, rays, semantic_nerfw)
            keys = [k for k in params if trainable(k)]
            grads = dict(zip(keys, torch.autograd.grad(total, [params[k] for k in keys],
                                                       allow_unused=True)))
            grads = {k: (torch.zeros_like(params[k]) if g is None else g)
                     for k, g in grads.items()}
            grads = opt.clipped(grads)
            if first is None:
                first = {k: g.detach().clone() for k, g in grads.items()}
            opt.step(params, grads)
            losses.append(float(total.detach()))
            del out, total, grads
        return {"losses": losses, "grads": first,
                "params": {k: v.detach() for k, v in params.items()}}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
