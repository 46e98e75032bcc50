"""Fourier-feature neural fields on the fused path: the nerfacto field
(density + rgb, and semantics), and the proposal density fields.

Positions arrive coordinate-major, (3, R, S). Contraction, the coarse-to-fine
window (folded into the first layer's weights), the 2*pi on B for the sincos
basis, the density activation and the SH view features stay here, outside
the kernels, as in the JAX package.

Without semantics the nerfacto field is one fully fused kernel (base MLP and
rgb MLP together, ``fourier_field_mlp``). With semantics it splits, as the JAX
package's does: the base MLP runs alone in ``fourier_mlp`` (the proposal
fields' kernel, here at the base MLP's widths), and the rgb head and the
semantic head are plain matrix products on its output.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from nerf_kbs_tpu_torch.ops.contraction import contract_to_unit_cube_t
from nerf_kbs_tpu_torch.ops.encoding import (
    FourierEncodingConfig,
    fourier_encoding_init,
    sh_encoding,
)
from nerf_kbs_tpu_torch.ops.fused_field import (
    FusedFieldSpec,
    FusedMLPSpec,
    fourier_field_mlp,
    fourier_mlp,
)
from nerf_kbs_tpu_torch.ops.mlp import MLPConfig, mlp_apply_t, mlp_init, trunc_exp


@dataclasses.dataclass(frozen=True)
class NerfactoFieldConfig:
    num_images: int = 1
    encoding: str = "hash"
    fourier: FourierEncodingConfig = FourierEncodingConfig()
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
    compute_dtype: str = "float32"

    @property
    def base_mlp(self) -> MLPConfig:
        return MLPConfig(
            in_dim=self.fourier.output_dim,
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


@dataclasses.dataclass(frozen=True)
class DensityFieldConfig:
    encoding: str = "hash"
    fourier: FourierEncodingConfig = FourierEncodingConfig(
        num_levels=5, features_per_level=16, base_resolution=16, max_resolution=128
    )
    hidden_dim: int = 16
    num_layers: int = 2
    compute_dtype: str = "float32"

    @property
    def mlp(self) -> MLPConfig:
        return MLPConfig(
            in_dim=self.fourier.output_dim,
            num_layers=self.num_layers,
            layer_width=self.hidden_dim,
            out_dim=1,
            compute_dtype=self.compute_dtype,
        )


def _require_fourier(cfg) -> None:
    if cfg.encoding != "fourier":
        raise NotImplementedError(
            f"encoding={cfg.encoding!r}: only the fourier field is ported"
        )


def nerfacto_field_init(cfg: NerfactoFieldConfig, generator: torch.Generator, device) -> dict:
    _require_fourier(cfg)
    params = {
        "fourier_B": fourier_encoding_init(cfg.fourier, generator, device),
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
    return params


def density_field_init(cfg: DensityFieldConfig, generator: torch.Generator, device) -> dict:
    _require_fourier(cfg)
    return {
        "fourier_B": fourier_encoding_init(cfg.fourier, generator, device),
        "mlp": mlp_init(cfg.mlp, generator, device),
    }


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
