"""Semantic NeRF-W: nerfacto with the semantic head, monocular depth and
motion masks, for driving scenes (the JAX package's
``models/semantic_nerfw.py``).

Without the transient embedding the model is nerfacto with semantics, and the
forward is ``nerfacto.forward``: as registered (the hash field) on the
non-fused path, with ``--model.field_type fourier`` on the fused path's split
field. The loss
differs from nerfacto's: the interlevel and distortion terms are always
there, the rgb term is masked when ``use_mask`` and a mask comes, the
semantic term ('semantics_loss') also counts at eval, the depth term
('depth_loss') is the scale-and-shift-invariant one, and 'psnr' is over the
masked pixels whenever the batch has a mask. The NeRF-W transient path
(``use_transient_embedding=True``: the combined weights, the uncertainty and
their loss terms) is not ported and raises by name; the field's transient
heads are (``models.fields.nerfacto_field_apply``).
"""

from __future__ import annotations

import dataclasses

import torch

from nerf_kbs_tpu_torch.models import nerfacto as _nerfacto
from nerf_kbs_tpu_torch.ops import losses as L
from nerf_kbs_tpu_torch.ops.metrics import masked_psnr


@dataclasses.dataclass(frozen=True)
class SemanticNerfWConfig(_nerfacto.NerfactoConfig):
    use_transient_embedding: bool = False
    use_semantic: bool = True
    semantic_loss_weight: float = 0.05
    mono_depth_loss_mult: float = 0.001
    uncertainty_min: float = 0.03
    transient_density_loss_mult: float = 0.01

    @property
    def field(self):
        return dataclasses.replace(super().field,
                                   use_transient_embedding=self.use_transient_embedding)


def check_supported(cfg: SemanticNerfWConfig) -> None:
    if cfg.use_transient_embedding:
        raise NotImplementedError(
            "use_transient_embedding=True is not ported (the NeRF-W transient and "
            "uncertainty path)")
    _nerfacto.check_supported(cfg)


def init(cfg: SemanticNerfWConfig, seed: int = 0, device=None) -> dict:
    check_supported(cfg)
    return _nerfacto.init(cfg, seed=seed, device=device)


param_groups = _nerfacto.param_groups


def forward(params: dict, cfg: SemanticNerfWConfig, rays, step: float = 0, train: bool = False,
            generator=None, jitters=None) -> dict:
    """``nerfacto.forward``: the outputs hold 'semantics' when
    ``use_semantic``."""
    check_supported(cfg)
    return _nerfacto.forward(params, cfg, rays, step=step, train=train, generator=generator,
                             jitters=jitters)


def loss(cfg: SemanticNerfWConfig, outputs: dict, batch: dict, train: bool = True):
    """(total, metrics); see the module docstring for the terms."""
    check_supported(cfg)
    gt, pred = batch["image"], outputs["rgb"]
    losses = {}
    if train:
        losses["interlevel_loss"] = cfg.interlevel_loss_mult * L.interlevel_loss(
            *_nerfacto._first_ray_args(outputs, gt.shape[0], cfg.interlevel_ray_fraction))
        losses["distortion_loss"] = cfg.distortion_loss_mult * L.distortion_loss(
            outputs["ray_samples"], outputs["weights"])
    if cfg.use_mask and "mask" in batch:
        losses["rgb_loss"] = _nerfacto.masked_rgb_loss(pred, gt, batch["mask"])
    else:
        losses["rgb_loss"] = L.mse_loss(pred, gt)
    if cfg.use_semantic and "semantics_label" in batch:
        losses["semantics_loss"] = cfg.semantic_loss_weight * L.semantic_loss(
            outputs["semantics"], batch["semantics_label"])
    if train and cfg.use_depth and "depth_image" in batch:
        depth_gt = batch["depth_image"]
        if not cfg.is_euclidean_depth:
            depth_gt = depth_gt * outputs["directions_norm"]
        losses["depth_loss"] = cfg.mono_depth_loss_mult * L.monodepth_loss(
            outputs["depth"], depth_gt, batch.get("mask"))
    total = sum(losses.values())
    if "mask" in batch:
        psnr = masked_psnr(pred.detach(), gt, batch["mask"][..., 0])
    else:
        psnr = 10.0 * torch.log10(1.0 / torch.clamp_min(L.mse_loss(pred, gt).detach(), 1e-12))
    return total, {"psnr": psnr, **losses}
