"""Neural fields: the nerfacto field (density, rgb, and the semantic,
transient and predicted-normal heads) and the proposal density fields, on two
paths, as in the JAX package.

The non-fused path (``nerfacto_field_apply``, ``density_field_apply``) takes
point-major positions (R, S, 3) and runs any of the three encodings (hash
grid, CP line grid, Fourier features) and plain MLPs, with the scene
contraction or, when it is disabled, the [-1, 1]^3 box and zero density
outside it. It carries every head and the analytic normals (the gradient of
the density with respect to the positions).

The fused path (the ``_t`` functions) is the Fourier field on the
hand-written kernels. Positions arrive coordinate-major, (3, R, S).
Contraction, the coarse-to-fine window (folded into the first layer's
weights), the 2*pi on B for the sincos basis, the density activation and the
SH view features stay here, outside the kernels. Without semantics the
nerfacto field is one fully fused kernel (base MLP and rgb MLP together,
``fourier_field_mlp``). With semantics it splits: the base MLP runs alone in
``fourier_mlp`` (the proposal fields' kernel, here at the base MLP's widths),
and the rgb head and the semantic head are plain matrix products on its
output. The model picks the path by its config (``models.nerfacto``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from nerf_kbs_tpu_torch.ops.contraction import (
    contract_to_unit_cube,
    contract_to_unit_cube_t,
    normalize_aabb,
)
from nerf_kbs_tpu_torch.ops.encoding import (
    CPEncodingConfig,
    FourierEncodingConfig,
    HashEncodingConfig,
    cp_encoding_apply,
    cp_encoding_init,
    fourier_encoding_apply,
    fourier_encoding_init,
    hash_encoding_apply,
    hash_encoding_init,
    hash_encoding_plain,
    positional_encoding,
    sh_encoding,
)
from nerf_kbs_tpu_torch.ops.fused_field import (
    FusedFieldSpec,
    FusedMLPSpec,
    fourier_field_mlp,
    fourier_mlp,
)
from nerf_kbs_tpu_torch.ops.mlp import MLPConfig, mlp_apply, mlp_apply_t, mlp_init, trunc_exp


def _encoding_dim(cfg) -> int:
    return {"hash": cfg.hash, "fourier": cfg.fourier, "cp": cfg.cp}[cfg.encoding].output_dim


@dataclasses.dataclass(frozen=True)
class NerfactoFieldConfig:
    num_images: int = 1
    encoding: str = "hash"  # hash | fourier | cp
    hash: HashEncodingConfig = HashEncodingConfig()
    fourier: FourierEncodingConfig = FourierEncodingConfig()
    cp: CPEncodingConfig = CPEncodingConfig()
    hidden_dim: int = 64
    num_layers: int = 2
    geo_feat_dim: int = 15
    hidden_dim_color: int = 64
    num_layers_color: int = 3
    appearance_embedding_dim: int = 32
    use_average_appearance_embedding: bool = True
    sh_levels: int = 4
    use_semantics: bool = False
    num_semantic_classes: int = 0
    hidden_dim_semantics: int = 64
    use_transient_embedding: bool = False
    transient_embedding_dim: int = 16
    hidden_dim_transient: int = 64
    use_pred_normals: bool = False
    disable_scene_contraction: bool = False
    compute_dtype: str = "float32"

    @property
    def encoding_dim(self) -> int:
        return _encoding_dim(self)

    @property
    def base_mlp(self) -> MLPConfig:
        return MLPConfig(
            in_dim=self.encoding_dim,
            num_layers=self.num_layers,
            layer_width=self.hidden_dim,
            out_dim=1 + self.geo_feat_dim,
            compute_dtype=self.compute_dtype,
        )

    @property
    def rgb_mlp(self) -> MLPConfig:
        return MLPConfig(
            in_dim=self.geo_feat_dim + self.sh_levels**2 + self.appearance_embedding_dim,
            num_layers=self.num_layers_color,
            layer_width=self.hidden_dim_color,
            out_dim=3,
            compute_dtype=self.compute_dtype,
            out_activation="sigmoid",
        )

    @property
    def semantic_mlp(self) -> MLPConfig:
        return MLPConfig(
            in_dim=self.geo_feat_dim,
            num_layers=2,
            layer_width=self.hidden_dim_semantics,
            out_dim=self.num_semantic_classes,
            compute_dtype=self.compute_dtype,
        )

    @property
    def transient_mlp(self) -> MLPConfig:
        """The NeRF-W transient trunk on [geo; transient embedding]; the
        transient density, rgb and uncertainty heads read its output."""
        return MLPConfig(
            in_dim=self.geo_feat_dim + self.transient_embedding_dim,
            num_layers=2,
            layer_width=self.hidden_dim_transient,
            out_dim=self.hidden_dim_transient,
            compute_dtype=self.compute_dtype,
        )

    def transient_head(self, out_dim: int) -> MLPConfig:
        """One linear layer on the trunk's output, in f32 whatever the
        compute dtype (the JAX package's heads take the default)."""
        return MLPConfig(self.hidden_dim_transient, 1, self.hidden_dim_transient, out_dim)

    @property
    def pred_normal_mlp(self) -> MLPConfig:
        return MLPConfig(
            in_dim=self.geo_feat_dim + 3 * 2 * 4 + 3,  # positional_encoding(x, 4) with x
            num_layers=3,
            layer_width=64,
            out_dim=3,
            compute_dtype=self.compute_dtype,
        )


@dataclasses.dataclass(frozen=True)
class DensityFieldConfig:
    encoding: str = "hash"
    hash: HashEncodingConfig = HashEncodingConfig(
        num_levels=5, features_per_level=2, log2_hashmap_size=17,
        base_resolution=16, max_resolution=128,
    )
    fourier: FourierEncodingConfig = FourierEncodingConfig(
        num_levels=5, features_per_level=16, base_resolution=16, max_resolution=128
    )
    cp: CPEncodingConfig = CPEncodingConfig(
        num_levels=5, features_per_level=8, base_resolution=16, max_resolution=128
    )
    hidden_dim: int = 16
    num_layers: int = 2
    disable_scene_contraction: bool = False
    compute_dtype: str = "float32"

    @property
    def encoding_dim(self) -> int:
        return _encoding_dim(self)

    @property
    def mlp(self) -> MLPConfig:
        return MLPConfig(
            in_dim=self.encoding_dim,
            num_layers=self.num_layers,
            layer_width=self.hidden_dim,
            out_dim=1,
            compute_dtype=self.compute_dtype,
        )


def _require_fourier(cfg) -> None:
    if cfg.encoding != "fourier":
        raise NotImplementedError(
            f"encoding={cfg.encoding!r} on the fused path: the fused kernels take the "
            f"fourier field only (nerfacto_field_apply / density_field_apply take every one)"
        )


def _encoding_init(cfg, generator: torch.Generator, device) -> dict:
    if cfg.encoding == "hash":
        return {"hash_table": hash_encoding_init(cfg.hash, generator, device)}
    if cfg.encoding == "fourier":
        return {"fourier_B": fourier_encoding_init(cfg.fourier, generator, device)}
    if cfg.encoding == "cp":
        return {"cp_tables": cp_encoding_init(cfg.cp, generator, device)}
    raise ValueError(f"unknown encoding {cfg.encoding!r} (hash, fourier or cp)")


def nerfacto_field_init(cfg: NerfactoFieldConfig, generator: torch.Generator, device) -> dict:
    """Parameters drawn on the CPU from ``generator`` and moved to
    ``device``: the encoding's ('hash_table', 'fourier_B' or 'cp_tables'),
    'base_mlp', 'rgb_mlp' and, as the config asks, 'appearance_emb',
    'semantic_mlp', the transient embedding, trunk and heads, and
    'pred_normal_mlp'."""
    params = {
        **_encoding_init(cfg, generator, device),
        "base_mlp": mlp_init(cfg.base_mlp, generator, device),
        "rgb_mlp": mlp_init(cfg.rgb_mlp, generator, device),
    }
    if cfg.appearance_embedding_dim > 0:
        emb = torch.randn(cfg.num_images, cfg.appearance_embedding_dim, generator=generator)
        params["appearance_emb"] = (emb * 0.1).to(device)
    if cfg.use_semantics:
        if cfg.num_semantic_classes <= 0:
            raise ValueError(
                "use_semantics=True needs num_semantic_classes > 0: give the dataset's "
                "class count, or switch the semantic head off")
        params["semantic_mlp"] = mlp_init(cfg.semantic_mlp, generator, device)
    if cfg.use_transient_embedding:
        emb = torch.randn(cfg.num_images, cfg.transient_embedding_dim, generator=generator)
        params["transient_emb"] = (emb * 0.1).to(device)
        params["transient_mlp"] = mlp_init(cfg.transient_mlp, generator, device)
        for name, od in (("transient_density_head", 1), ("transient_rgb_head", 3),
                         ("uncertainty_head", 1)):
            params[name] = mlp_init(cfg.transient_head(od), generator, device)
    if cfg.use_pred_normals:
        params["pred_normal_mlp"] = mlp_init(cfg.pred_normal_mlp, generator, device)
    return params


def density_field_init(cfg: DensityFieldConfig, generator: torch.Generator, device) -> dict:
    return {**_encoding_init(cfg, generator, device), "mlp": mlp_init(cfg.mlp, generator, device)}


# ---------------------------------------------------------------------------
# the non-fused path: point-major positions, every encoding and head
# ---------------------------------------------------------------------------


def _normalize(cfg, positions: torch.Tensor) -> torch.Tensor:
    """Positions (..., 3) -> the encodings' [0, 1]^3: the [-1, 1]^3 box when
    the contraction is disabled, else the L-inf contraction."""
    if cfg.disable_scene_contraction:
        box = torch.tensor([[-1.0] * 3, [1.0] * 3], device=positions.device)
        return normalize_aabb(positions, box)
    return contract_to_unit_cube(positions)


def _field_encode(params: dict, cfg, x: torch.Tensor, window=None,
                  plain_hash: bool = False) -> torch.Tensor:
    """The encoding of normalised positions x (..., 3); ``window`` (fourier
    only): the coarse-to-fine weights of ``ops.encoding.fourier_window``;
    ``plain_hash``: ``ops.encoding.hash_encoding_plain``, which differentiates
    twice, on every device, in place of the hash grid's once-differentiable
    operation."""
    if cfg.encoding == "hash":
        encode = hash_encoding_plain if plain_hash else hash_encoding_apply
        return encode(params["hash_table"], x, cfg.hash)
    if cfg.encoding == "cp":
        return cp_encoding_apply(params["cp_tables"], x, cfg.cp)
    return fourier_encoding_apply(params["fourier_B"], x, cfg.fourier, window=window)


def _density_from_base(h: torch.Tensor):
    """The trunk's output split into (density, geo features); the -1 keeps
    the field near-empty at initialisation."""
    return trunc_exp(h[..., 0] - 1.0), h[..., 1:]


def _in_box_selector(x: torch.Tensor) -> torch.Tensor:
    """1 inside [0, 1]^3, else 0: without the contraction the density is
    zero outside the box, where the encodings read their edge cells."""
    return torch.all((x >= 0.0) & (x <= 1.0), dim=-1).float()


def _density(params: dict, cfg, mlp_key: str, positions: torch.Tensor, window,
             plain_hash: bool = False):
    """(density, geo, x) of the non-fused path."""
    x = _normalize(cfg, positions)
    h = mlp_apply(params[mlp_key], _field_encode(params, cfg, x, window, plain_hash),
                  getattr(cfg, mlp_key))
    density, geo = _density_from_base(h)
    if cfg.disable_scene_contraction:
        density = density * _in_box_selector(x)
    return density, geo, x


def nerfacto_density(params: dict, cfg: NerfactoFieldConfig, positions: torch.Tensor,
                     window=None, plain_hash: bool = False) -> torch.Tensor:
    """The nerfacto field's density alone, positions (..., 3) -> (...)."""
    return _density(params, cfg, "base_mlp", positions, window, plain_hash)[0]


def _unit(v: torch.Tensor) -> torch.Tensor:
    # eps inside the square root: finite gradients at v = 0
    return v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-12)


def _normals(params: dict, cfg: NerfactoFieldConfig, positions: torch.Tensor,
             window) -> torch.Tensor:
    """Unit normals (R, S, 3): minus the gradient of the windowed density
    with respect to the positions. With gradients on (training), the result
    keeps its graph, so a loss on it differentiates twice (through the
    encoding, trunc_exp and the MLPs) and reaches the positions' own
    parameters too; under ``torch.no_grad`` (eval) it is computed in a local
    ``enable_grad`` and comes back detached."""
    grad_on = torch.is_grad_enabled()
    with torch.enable_grad():
        p = positions if (grad_on and positions.requires_grad) else \
            positions.detach().requires_grad_(True)
        # differentiated twice: the plain hash encoding (the hash grid's
        # operation is once differentiable)
        density = nerfacto_density(params, cfg, p, window, plain_hash=True)
        (grad,) = torch.autograd.grad(density.sum(), p, create_graph=grad_on)
    return _unit(-grad)


def nerfacto_field_apply(
    params: dict,
    cfg: NerfactoFieldConfig,
    positions: torch.Tensor,
    directions: torch.Tensor,
    camera_indices: torch.Tensor,
    train: bool = False,
    compute_normals: bool = False,
    window=None,
) -> dict:
    """The field on the non-fused path: positions (R, S, 3), directions
    (R, 3) unit, camera_indices (R, 1). Returns 'density' (R, S) and 'rgb'
    (R, S, 3), and as the config asks 'semantics' (R, S, C) logits (on geo
    with its gradient stopped), in training the transient heads
    'transient_density' (R, S), 'transient_rgb' (R, S, 3) and 'uncertainty'
    (R, S), 'pred_normals' (R, S, 3) and, with ``compute_normals``, 'normals'
    (R, S, 3). Appearance rows are per camera in training and the mean row at
    eval (with ``use_average_appearance_embedding``)."""
    R, S, _ = positions.shape
    density, geo, x = _density(params, cfg, "base_mlp", positions, window)

    d_enc = sh_encoding(directions, cfg.sh_levels)
    rows = [geo, d_enc[:, None, :].expand(R, S, -1)]
    cam = camera_indices[..., 0].long()
    if cfg.appearance_embedding_dim > 0:
        table = params["appearance_emb"]
        if train or not cfg.use_average_appearance_embedding:
            app = table[cam]
        else:
            app = table.mean(dim=0).expand(R, -1)
        rows.append(app[:, None, :].expand(R, S, -1))
    out = {"density": density,
           "rgb": mlp_apply(params["rgb_mlp"], torch.cat(rows, dim=-1), cfg.rgb_mlp)}

    if cfg.use_semantics:
        out["semantics"] = mlp_apply(params["semantic_mlp"], geo.detach(), cfg.semantic_mlp)

    if cfg.use_transient_embedding and train:
        t_emb = params["transient_emb"][cam][:, None, :].expand(R, S, -1)
        t_h = mlp_apply(params["transient_mlp"], torch.cat([geo, t_emb], dim=-1),
                        cfg.transient_mlp)

        def head(name, od):
            return mlp_apply(params[name], t_h, cfg.transient_head(od))

        softplus = torch.nn.functional.softplus
        out["transient_density"] = softplus(head("transient_density_head", 1)[..., 0] - 3.0)
        out["transient_rgb"] = torch.sigmoid(head("transient_rgb_head", 3))
        # the 0.03 floor of the uncertainty is the model's (uncertainty_min)
        out["uncertainty"] = softplus(head("uncertainty_head", 1)[..., 0])

    if cfg.use_pred_normals:
        p_enc = positional_encoding(x, 4, include_input=True)
        pn = mlp_apply(params["pred_normal_mlp"], torch.cat([geo, p_enc], dim=-1),
                       cfg.pred_normal_mlp)
        out["pred_normals"] = _unit(pn)

    if compute_normals:
        # the same windowed field that renders: without the window the early
        # normals would be gradients of frequencies the render never sees
        out["normals"] = _normals(params, cfg, positions, window)
    return out


def density_field_apply(params: dict, cfg: DensityFieldConfig, positions: torch.Tensor,
                        window=None) -> torch.Tensor:
    """A proposal field on the non-fused path: positions (..., 3) -> density (...)."""
    return _density(params, cfg, "mlp", positions, window)[0]


# ---------------------------------------------------------------------------
# the fused path: coordinate-major positions, the Fourier field on the kernels
# ---------------------------------------------------------------------------


def _kernel_inputs(params, fourier_cfg, mlp_params, x_t, window):
    """Contracted flat positions, B as the kernels take it (times 2*pi for
    sincos only), and the weights with the window folded into W0:
    ([s, c] * [win, win]) @ W0 == [s, c] @ (concat(win, win)[:, None] * W0)."""
    x = contract_to_unit_cube_t(x_t).reshape(3, -1)
    B = params["fourier_B"].detach()  # frozen frequencies
    if fourier_cfg.basis != "tri":
        B = B * (2.0 * math.pi)
    ws, bs = list(mlp_params["w"]), list(mlp_params["b"])
    if window is not None:
        ws[0] = ws[0] * torch.cat([window, window])[:, None]
    return x, B, ws, bs


def _dims(ws) -> tuple:
    return tuple([w.shape[0] for w in ws] + [ws[-1].shape[1]])


def _is_bf16(compute_dtype: str) -> bool:
    return compute_dtype == "bfloat16"


def _fourier_fused_call(params_key_mlp: str, params, fourier_cfg, mlp_cfg, x_t, window,
                        need_dx: bool = True):
    """Fused evaluation of one Fourier MLP: x_t (3, R, S) raw positions ->
    (out_dim, R, S). ``need_dx=False`` tells the backward that positions are
    constants."""
    R, S = x_t.shape[1], x_t.shape[2]
    x, B, ws, bs = _kernel_inputs(params, fourier_cfg, params[params_key_mlp], x_t, window)
    spec = FusedMLPSpec(
        h_freqs=B.shape[1], layer_dims=_dims(ws),
        bf16=_is_bf16(mlp_cfg.compute_dtype), basis=fourier_cfg.basis, need_dx=need_dx,
    )
    return fourier_mlp(spec, x, B, ws, bs).reshape(-1, R, S)


def density_field_apply_t(params: dict, cfg: DensityFieldConfig, x_t: torch.Tensor,
                          window=None, need_dx: bool = True) -> torch.Tensor:
    """Coordinate-major density: x_t (3, R, S) -> density (R, S)."""
    _require_fourier(cfg)
    out = _fourier_fused_call("mlp", params, cfg.fourier, cfg.mlp, x_t, window, need_dx)
    return trunc_exp(out[0] - 1.0)


def nerfacto_field_apply_t(
    params: dict,
    cfg: NerfactoFieldConfig,
    x_t: torch.Tensor,
    directions: torch.Tensor,
    camera_indices: torch.Tensor,
    train: bool = False,
    window=None,
    need_dx: bool = True,
) -> dict:
    """The field on the fused path: x_t (3, R, S) raw positions, directions
    (R, 3), camera_indices (R, 1). Returns 'density' (R, S) and 'rgb_t' (3,
    R, S), and with semantics 'semantics_t' (C, R, S) logits. With ``train``
    the appearance rows are per camera, and the table learns through the
    gradient of the per-point feats summed over each ray's samples."""
    _require_fourier(cfg)
    R, S = x_t.shape[1], x_t.shape[2]

    # per-point conditioning rows: SH view features, then appearance
    rows = [sh_encoding(directions, cfg.sh_levels).T]  # (16, R)
    if cfg.appearance_embedding_dim > 0:
        table = params["appearance_emb"]
        if train or not cfg.use_average_appearance_embedding:
            rows.append(table[camera_indices[:, 0].long()].T)
        else:
            rows.append(table.mean(dim=0)[:, None].expand(-1, R))
    feats = torch.cat(rows, dim=0)
    feats = feats[:, :, None].expand(-1, R, S).reshape(feats.shape[0], R * S)

    if cfg.use_semantics:
        return _split_field(params, cfg, x_t, feats, window, need_dx)

    x, B, ws, bs = _kernel_inputs(params, cfg.fourier, params["base_mlp"], x_t, window)
    rgb = params["rgb_mlp"]
    spec = FusedFieldSpec(
        h_freqs=B.shape[1],
        feat_dim=feats.shape[0],
        base_dims=_dims(ws),
        rgb_dims=_dims(rgb["w"]),
        bf16=_is_bf16(cfg.compute_dtype),
        basis=cfg.fourier.basis,
        need_dx=need_dx,
    )
    out4 = fourier_field_mlp(spec, x, feats, B, ws, bs, list(rgb["w"]), list(rgb["b"]))
    return {
        "density": trunc_exp(out4[0].reshape(R, S) - 1.0),
        "rgb_t": out4[1:].reshape(3, R, S),
    }


def _split_field(params, cfg: NerfactoFieldConfig, x_t, feats, window, need_dx: bool) -> dict:
    """The semantics path: the base MLP in ``fourier_mlp`` (its gradient on
    all 1 + geo outputs comes back through that kernel's backward), the rgb
    head on [geo; feats] and the semantic head on geo with its gradient
    stopped, both plain products."""
    R, S = x_t.shape[1], x_t.shape[2]
    h = _fourier_fused_call("base_mlp", params, cfg.fourier, cfg.base_mlp, x_t, window, need_dx)
    geo = h[1:].reshape(cfg.geo_feat_dim, R * S)
    rgb_t = mlp_apply_t(params["rgb_mlp"], torch.cat([geo, feats], dim=0), cfg.rgb_mlp)
    sem_t = mlp_apply_t(params["semantic_mlp"], geo.detach(), cfg.semantic_mlp)
    return {
        "density": trunc_exp(h[0] - 1.0),
        "rgb_t": rgb_t.reshape(3, R, S),
        "semantics_t": sem_t.reshape(-1, R, S),
    }
