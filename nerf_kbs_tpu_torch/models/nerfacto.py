"""nerfacto at eval on the fused Fourier path: proposal chain -> field ->
composite.

Covered: the fourier field with contraction, the eval forward
(``train=False``), the 'last_sample' / 'white' / 'black' backgrounds and
appearance embeddings. Anything else raises NotImplementedError naming the
setting: hash or cp fields, semantics, normals, the camera optimizer,
disabled contraction and ``train=True`` (the training slice).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from nerf_kbs_tpu_torch.cameras.cameras import RayBundle
from nerf_kbs_tpu_torch.device import resolve_device
from nerf_kbs_tpu_torch.models.fields import (
    DensityFieldConfig,
    NerfactoFieldConfig,
    density_field_apply_t,
    density_field_init,
    nerfacto_field_apply_t,
    nerfacto_field_init,
)
from nerf_kbs_tpu_torch.ops import rendering as R
from nerf_kbs_tpu_torch.ops.encoding import FourierEncodingConfig, fourier_window
from nerf_kbs_tpu_torch.ops.samplers import proposal_sample


@dataclasses.dataclass(frozen=True)
class NerfactoConfig:
    """The eval-relevant surface of the JAX package's NerfactoConfig, with
    the same names and defaults."""

    num_images: int = 1
    field_type: str = "hash"
    fourier_num_levels: int = 8
    fourier_features_per_level: int = 32
    fourier_basis: str = "sincos"
    proposal_fourier_basis: str = "tri"
    proposal_fourier_features_per_level: int = 16
    fourier_anneal_steps: int = 5000
    near_plane: float = 0.001
    far_plane: float = 1000.0
    background_color: str = "last_sample"
    hidden_dim: int = 64
    num_layers: int = 2
    hidden_dim_color: int = 64
    base_res: int = 16
    max_res: int = 2048
    num_proposal_samples_per_ray: Tuple[int, ...] = (256, 96)
    num_nerf_samples_per_ray: int = 48
    num_proposal_iterations: int = 2
    proposal_hidden_dim: int = 16
    proposal_num_levels: int = 5
    proposal_max_res: Tuple[int, ...] = (128, 256)
    proposal_initial_sampler: str = "piecewise"
    use_average_appearance_embedding: bool = True
    predict_normals: bool = False
    disable_scene_contraction: bool = False
    use_semantic: bool = False
    appearance_embedding_dim: int = 32
    compute_dtype: str = "float32"
    camera_optimizer: str = "off"

    @property
    def field(self) -> NerfactoFieldConfig:
        return NerfactoFieldConfig(
            num_images=self.num_images,
            encoding=self.field_type,
            fourier=FourierEncodingConfig(
                num_levels=self.fourier_num_levels,
                features_per_level=self.fourier_features_per_level,
                base_resolution=self.base_res,
                max_resolution=self.max_res,
                basis=self.fourier_basis,
            ),
            hidden_dim=self.hidden_dim,
            num_layers=self.num_layers,
            hidden_dim_color=self.hidden_dim_color,
            appearance_embedding_dim=self.appearance_embedding_dim,
            use_average_appearance_embedding=self.use_average_appearance_embedding,
            use_semantics=self.use_semantic,
            compute_dtype=self.compute_dtype,
        )

    def proposal_field(self, i: int) -> DensityFieldConfig:
        return DensityFieldConfig(
            encoding=self.field_type,
            fourier=FourierEncodingConfig(
                num_levels=self.proposal_num_levels,
                features_per_level=self.proposal_fourier_features_per_level,
                base_resolution=16,
                max_resolution=self.proposal_max_res[i],
                basis=self.proposal_fourier_basis,
            ),
            hidden_dim=self.proposal_hidden_dim,
            compute_dtype=self.compute_dtype,
        )


def _check_supported(cfg: NerfactoConfig, train: bool = False) -> None:
    unsupported = {
        "field_type": cfg.field_type != "fourier",
        "use_semantic": cfg.use_semantic,
        "predict_normals": cfg.predict_normals,
        "camera_optimizer": cfg.camera_optimizer != "off",
        "disable_scene_contraction": cfg.disable_scene_contraction,
    }
    for name, bad in unsupported.items():
        if bad:
            raise NotImplementedError(
                f"{name}={getattr(cfg, name)!r} is not ported (fused fourier eval path only)"
            )
    if train:
        raise NotImplementedError("train=True: the training forward is not ported yet")


def init(cfg: NerfactoConfig, seed: int = 0, device=None) -> dict:
    """Parameters from ``seed`` (drawn on the CPU with one torch.Generator,
    then moved): {"fields": {...}, "proposal_networks": [{...}, ...]}."""
    _check_supported(cfg)
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    return {
        "fields": nerfacto_field_init(cfg.field, g, dev),
        "proposal_networks": [
            density_field_init(cfg.proposal_field(i), g, dev)
            for i in range(cfg.num_proposal_iterations)
        ],
    }


def forward(
    params: dict,
    cfg: NerfactoConfig,
    rays: RayBundle,
    step: float = 0,
    train: bool = False,
) -> dict:
    """Render a batch of rays (R,) at eval: 'rgb' (R, 3), 'accumulation',
    'depth' (median), 'expected_depth', 'prop_depth_i', 'directions_norm'
    (R, 1), plus 'weights' (R, S)."""
    _check_supported(cfg, train)
    rays = R.near_far_collider(rays, cfg.near_plane, cfg.far_plane)
    dev = rays.origins.device

    # the coarse-to-fine window from step (anneal_steps <= 0: fully open)
    if cfg.fourier_anneal_steps > 0:
        progress = min(max(float(step) / cfg.fourier_anneal_steps, 0.0), 1.0)
    else:
        progress = 1.0
    field_window = fourier_window(cfg.field.fourier, progress, dev)
    density_fns = [
        (lambda pos_t, p=params["proposal_networks"][i], c=cfg.proposal_field(i):
         density_field_apply_t(p, c, pos_t, window=fourier_window(c.fourier, progress, dev)))
        for i in range(cfg.num_proposal_iterations)
    ]
    # proposal weight anneal is 1 at eval
    samples, history = proposal_sample(
        rays,
        density_fns,
        cfg.num_proposal_samples_per_ray,
        cfg.num_nerf_samples_per_ray,
        spacing=cfg.proposal_initial_sampler,
        anneal=1.0,
    )
    field_out = nerfacto_field_apply_t(
        params["fields"], cfg.field, samples.positions_t(rays), rays.directions,
        rays.camera_indices, train=False, window=field_window,
    )
    weights = R.render_weights(field_out["density"], samples.deltas)

    rgb_t = field_out["rgb_t"]
    comp = torch.einsum("rs,drs->rd", weights, rgb_t)
    acc = torch.sum(weights, dim=-1, keepdim=True)
    if cfg.background_color == "last_sample":
        bg = rgb_t[:, :, -1].T
    elif cfg.background_color == "white":
        bg = torch.ones_like(comp)
    elif cfg.background_color == "black":
        bg = torch.zeros_like(comp)
    else:
        raise ValueError(f"unknown background_color {cfg.background_color!r}")

    outputs = {
        "rgb": comp + bg * (1.0 - acc),
        "accumulation": acc,
        "depth": R.render_median_depth(weights, samples),
        "expected_depth": R.render_expected_depth(weights, samples),
        "weights": weights,
        "directions_norm": rays.directions_norm,
    }
    for i, (ps, pw) in enumerate(history):
        outputs[f"prop_depth_{i}"] = R.render_median_depth(pw, ps)
    return outputs
