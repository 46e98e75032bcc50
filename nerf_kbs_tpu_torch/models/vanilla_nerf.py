"""Vanilla NeRF: coarse and fine positional-encoding MLPs, optionally with a
temporal-distortion MLP for dynamic scenes (the JAX package's
``models/vanilla_nerf.py``).

Each field is an 8 x 256 relu MLP on the positions' frequency encoding (10
frequencies) with the input concatenated again at layer 4, a softplus density
head and a 2-layer sigmoid rgb head on [features, directions' encoding (4
frequencies)]. The forward intersects each ray with the scene box ('aabb') or
sets constant planes ('near_far'), draws 64 uniform coarse samples, then 128
importance samples from the coarse weights merged with the coarse edges, and
composites both passes over a white background. With
``enable_temporal_distortion`` each sample moves by MLP([PE(x), t]), t the
camera's normalised time; the MLP's last layer starts at zero (no motion).
The loss is the coarse plus the fine rgb MSE. Every setting is ported.
"""

from __future__ import annotations

import dataclasses

import torch

from nerf_kbs_tpu_torch.cameras.cameras import RayBundle
from nerf_kbs_tpu_torch.device import resolve_device
from nerf_kbs_tpu_torch.ops import losses as L
from nerf_kbs_tpu_torch.ops import rendering as R
from nerf_kbs_tpu_torch.ops.encoding import positional_encoding
from nerf_kbs_tpu_torch.ops.mlp import MLPConfig, mlp_apply, mlp_init
from nerf_kbs_tpu_torch.ops.samplers import pdf_sampler, uniform_sampler


@dataclasses.dataclass(frozen=True)
class VanillaNerfConfig:
    """The JAX package's VanillaNerfConfig, field for field."""

    num_coarse_samples: int = 64
    num_importance_samples: int = 128
    pos_frequencies: int = 10
    dir_frequencies: int = 4
    mlp_num_layers: int = 8
    mlp_layer_width: int = 256
    skip_connections: tuple = (4,)
    near_plane: float = 0.05
    far_plane: float = 1000.0
    # 'aabb': near and far from the ray's intersection with the [-s, s]^3
    # box, so the uniform coarse samples land in the normalised scene;
    # 'near_far': constant planes
    collider: str = "aabb"
    aabb_scale: float = 1.0
    background_color: str = "white"
    enable_temporal_distortion: bool = False
    temporal_distortion_layers: int = 4
    temporal_distortion_width: int = 64
    compute_dtype: str = "float32"

    @property
    def pos_enc_dim(self) -> int:
        return 3 + 3 * 2 * self.pos_frequencies

    @property
    def dir_enc_dim(self) -> int:
        return 3 + 3 * 2 * self.dir_frequencies

    @property
    def base_mlp(self) -> MLPConfig:
        return MLPConfig(in_dim=self.pos_enc_dim, num_layers=self.mlp_num_layers,
                         layer_width=self.mlp_layer_width, out_dim=self.mlp_layer_width,
                         compute_dtype=self.compute_dtype,
                         skip_connections=self.skip_connections)

    @property
    def head_mlp(self) -> MLPConfig:
        return MLPConfig(in_dim=self.mlp_layer_width + self.dir_enc_dim, num_layers=2,
                         layer_width=self.mlp_layer_width // 2, out_dim=3,
                         compute_dtype=self.compute_dtype, out_activation="sigmoid")

    @property
    def density_mlp(self) -> MLPConfig:
        return MLPConfig(self.mlp_layer_width, 1, self.mlp_layer_width, 1)

    @property
    def distortion_mlp(self) -> MLPConfig:
        return MLPConfig(in_dim=self.pos_enc_dim + 1, num_layers=self.temporal_distortion_layers,
                         layer_width=self.temporal_distortion_width, out_dim=3,
                         compute_dtype=self.compute_dtype)


def _init_field(cfg: VanillaNerfConfig, g: torch.Generator, dev) -> dict:
    return {"base": mlp_init(cfg.base_mlp, g, dev),
            "density_head": mlp_init(cfg.density_mlp, g, dev),
            "rgb_head": mlp_init(cfg.head_mlp, g, dev)}


def init(cfg: VanillaNerfConfig, seed: int = 0, device=None) -> dict:
    """{"fields": {"coarse", "fine"}, "temporal_distortion"?}, drawn on the
    CPU from ``seed`` and moved to ``device``."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    params = {"fields": {"coarse": _init_field(cfg, g, dev), "fine": _init_field(cfg, g, dev)}}
    if cfg.enable_temporal_distortion:
        td = mlp_init(cfg.distortion_mlp, g, dev)
        # no motion at the start: random offsets of O(1) would scatter every
        # sample out of the scene
        td["w"][-1] = torch.zeros_like(td["w"][-1])
        td["b"][-1] = torch.zeros_like(td["b"][-1])
        params["temporal_distortion"] = td
    return params


def param_groups(params: dict) -> dict:
    """'fields' and, with the temporal distortion, 'temporal_distortion'."""
    return {k: params[k] for k in ("fields", "temporal_distortion") if k in params}


def _field_eval(field: dict, cfg: VanillaNerfConfig, positions: torch.Tensor,
                directions: torch.Tensor):
    """positions (R, S, 3), directions (R, 3) -> density (R, S), rgb (R, S, 3)."""
    h = mlp_apply(field["base"], positional_encoding(positions, cfg.pos_frequencies),
                  cfg.base_mlp)
    density = torch.nn.functional.softplus(mlp_apply(field["density_head"], h,
                                                     cfg.density_mlp)[..., 0])
    d_enc = positional_encoding(directions, cfg.dir_frequencies)
    d_enc = d_enc[:, None, :].expand(*h.shape[:-1], d_enc.shape[-1])
    return density, mlp_apply(field["rgb_head"], torch.cat([h, d_enc], dim=-1), cfg.head_mlp)


def _maybe_distort(params: dict, cfg: VanillaNerfConfig, positions: torch.Tensor, times):
    if not cfg.enable_temporal_distortion or times is None:
        return positions
    p_enc = positional_encoding(positions, cfg.pos_frequencies)
    t = times[:, None, :].expand(*positions.shape[:-1], 1)
    return positions + mlp_apply(params["temporal_distortion"], torch.cat([p_enc, t], dim=-1),
                                 cfg.distortion_mlp)


def forward(params: dict, cfg: VanillaNerfConfig, rays: RayBundle, step: float = 0,
            train: bool = False, generator=None, jitters=None) -> dict:
    """Render a batch of rays (R,): 'rgb' and 'rgb_coarse' (R, 3),
    'accumulation' and 'depth' (the expected depth) (R, 1), 'weights' (R, S)
    and 'ray_samples' of the fine pass. With ``train`` the coarse samples and
    the importance quantiles jitter, from ``generator`` or from ``jitters``
    (two (R, 1) tensors in [0, 1): the coarse, then the fine draw)."""
    dev = rays.origins.device
    if cfg.collider == "aabb":
        box = torch.tensor([[-cfg.aabb_scale] * 3, [cfg.aabb_scale] * 3], device=dev)
        rays = R.aabb_box_collider(rays, box, near_plane=cfg.near_plane)
    else:
        rays = R.near_far_collider(rays, cfg.near_plane, cfg.far_plane)
    if not train:
        generator, jitters = None, None
    jitters = [None, None] if jitters is None else jitters

    coarse = uniform_sampler(rays, cfg.num_coarse_samples, spacing="uniform",
                             generator=generator, jitter=jitters[0])
    pos_c = _maybe_distort(params, cfg, coarse.positions(rays), rays.times)
    density_c, rgb_c = _field_eval(params["fields"]["coarse"], cfg, pos_c, rays.directions)
    weights_c = R.render_weights(density_c, coarse.deltas)

    fine = pdf_sampler(rays, coarse, weights_c, cfg.num_importance_samples, spacing="uniform",
                       generator=generator, rand=jitters[1], include_original=True)
    pos_f = _maybe_distort(params, cfg, fine.positions(rays), rays.times)
    density_f, rgb_f = _field_eval(params["fields"]["fine"], cfg, pos_f, rays.directions)
    weights_f = R.render_weights(density_f, fine.deltas)
    return {
        "rgb_coarse": R.render_rgb(weights_c, rgb_c, cfg.background_color),
        "rgb": R.render_rgb(weights_f, rgb_f, cfg.background_color),
        "accumulation": R.render_accumulation(weights_f),
        "depth": R.render_expected_depth(weights_f, fine),
        "weights": weights_f,
        "ray_samples": fine,
    }


def loss(cfg: VanillaNerfConfig, outputs: dict, batch: dict, train: bool = True):
    """(coarse + fine rgb MSE, metrics): 'rgb_loss_coarse', 'rgb_loss_fine'
    and the fine pass's 'psnr'."""
    gt = batch["image"]
    coarse = L.mse_loss(outputs["rgb_coarse"], gt)
    fine = L.mse_loss(outputs["rgb"], gt)
    psnr = 10.0 * torch.log10(1.0 / torch.clamp_min(fine.detach(), 1e-12))
    return coarse + fine, {"rgb_loss_coarse": coarse, "rgb_loss_fine": fine, "psnr": psnr}
