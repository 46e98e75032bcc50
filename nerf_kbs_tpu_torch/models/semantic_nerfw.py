"""Semantic NeRF-W: nerfacto with the semantic head, monocular depth, motion
masks and the NeRF-W transient path, for driving scenes (the JAX package's
``models/semantic_nerfw.py``).

Without the transient embedding, and at eval, the model is nerfacto with
semantics, and the forward is ``nerfacto.forward``: as registered (the hash
field) on the non-fused path, with ``--model.field_type fourier`` on the
fused path's split field. With ``use_transient_embedding`` a training
forward runs the non-fused field with its transient heads: the colour is the
static colour composited with the weights of static + transient density,
plus the transient colour under the same weights; accumulation, depth,
semantics and the proposal losses read the static weights; the uncertainty
beta is the transient weights' composite of the per-sample uncertainty
(weights detached) plus ``uncertainty_min``.

The loss: the interlevel and distortion terms are always there in training,
and the camera optimizer's regularizer when the forward gave the tangents
(nerfacto's forward does; the transient one does not, as in the JAX
package); the rgb term is, with the transient path, the beta-weighted
mean(sum((gt - rgb)^2) / beta^2) together with 3 + mean(log beta) and
``transient_density_loss_mult`` times the mean transient density, else
masked when ``use_mask`` and a mask comes; the semantic term
('semantics_loss') also counts at eval; the depth term ('depth_loss') is the
scale-and-shift-invariant one; and 'psnr' is over the masked pixels whenever
the batch has a mask.
"""

from __future__ import annotations

import dataclasses

import torch

from nerf_kbs_tpu_torch.models import nerfacto as _nerfacto
from nerf_kbs_tpu_torch.models.fields import density_field_apply, nerfacto_field_apply
from nerf_kbs_tpu_torch.ops import losses as L
from nerf_kbs_tpu_torch.ops import rendering as R
from nerf_kbs_tpu_torch.ops.metrics import masked_psnr
from nerf_kbs_tpu_torch.ops.samplers import proposal_sample


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


def init(cfg: SemanticNerfWConfig, seed: int = 0, device=None) -> dict:
    return _nerfacto.init(cfg, seed=seed, device=device)


param_groups = _nerfacto.param_groups
camera_deltas = _nerfacto.camera_deltas


def forward(params: dict, cfg: SemanticNerfWConfig, rays, step: float = 0, train: bool = False,
            generator=None, jitters=None) -> dict:
    """``nerfacto.forward`` unless the transient path runs (training with
    ``use_transient_embedding``); then 'rgb', 'accumulation', 'depth'
    (median, static weights), 'weights' (static), 'ray_samples',
    'proposal_history', 'directions_norm', 'uncertainty' (R, 1),
    'density_transient' (R, S), 'prop_depth_i' and, with the semantic head,
    'semantics'. Jitter as in ``nerfacto.forward``."""
    if not (cfg.use_transient_embedding and train):
        return _nerfacto.forward(params, cfg, rays, step=step, train=train, generator=generator,
                                 jitters=jitters)
    rays = R.near_far_collider(rays, cfg.near_plane, cfg.far_plane)
    field_window, prop_windows = _nerfacto.windows(cfg, step, rays.origins.device)
    props = params["proposal_networks"]
    density_fns = [
        (lambda pos, p=props[i], c=cfg.proposal_field(i), w=prop_windows[i]:
         density_field_apply(p, c, pos, window=w))
        for i in range(cfg.num_proposal_iterations)
    ]
    samples, history = proposal_sample(
        rays, density_fns, cfg.num_proposal_samples_per_ray, cfg.num_nerf_samples_per_ray,
        spacing=cfg.proposal_initial_sampler, anneal=_nerfacto.proposal_anneal(cfg, step, train),
        generator=generator, single_jitter=cfg.use_single_jitter, jitters=jitters,
        stop_grad=cfg.stop_grad_sampling)
    field_out = nerfacto_field_apply(params["fields"], cfg.field, samples.positions(rays),
                                     rays.directions, rays.camera_indices, train=True,
                                     window=field_window)
    deltas = samples.deltas
    weights_static = R.render_weights(field_out["density"], deltas)
    weights = R.render_weights(field_out["density"] + field_out["transient_density"], deltas)
    weights_transient = R.render_weights(field_out["transient_density"], deltas)
    outputs = {
        "rgb": (R.render_rgb(weights, field_out["rgb"], cfg.background_color)
                + R.accumulate(weights, field_out["transient_rgb"])),
        "accumulation": R.render_accumulation(weights_static),
        "depth": R.render_median_depth(weights_static, samples),
        "weights": weights_static,
        "ray_samples": samples,
        "proposal_history": history,
        "directions_norm": rays.directions_norm,
        "uncertainty": (R.render_uncertainty(weights_transient, field_out["uncertainty"])
                        + cfg.uncertainty_min),
        "density_transient": field_out["transient_density"],
    }
    if cfg.use_semantic:
        outputs["semantics"] = R.render_semantics(weights_static, field_out["semantics"],
                                                  cfg.pass_semantic_gradients)
    for i, (ps, pw) in enumerate(history):
        outputs[f"prop_depth_{i}"] = R.render_median_depth(pw, ps)
    return outputs


def loss(cfg: SemanticNerfWConfig, outputs: dict, batch: dict, train: bool = True):
    """(total, metrics); see the module docstring for the terms."""
    gt, pred = batch["image"], outputs["rgb"]
    losses = {}
    if train:
        losses["interlevel_loss"] = cfg.interlevel_loss_mult * L.interlevel_loss(
            *_nerfacto._first_ray_args(outputs, gt.shape[0], cfg.interlevel_ray_fraction))
        losses["distortion_loss"] = cfg.distortion_loss_mult * L.distortion_loss(
            outputs["ray_samples"], outputs["weights"])
        losses.update(_nerfacto.camera_opt_regularizer(cfg, outputs))
    if train and "uncertainty" in outputs:
        betas = outputs["uncertainty"]
        losses["uncertainty_loss"] = 3.0 + torch.mean(torch.log(betas))
        losses["density_loss"] = cfg.transient_density_loss_mult * torch.mean(
            outputs["density_transient"])
        losses["rgb_loss"] = torch.mean(torch.sum((gt - pred) ** 2, dim=-1) / betas[..., 0] ** 2)
    elif cfg.use_mask and "mask" in batch:
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
