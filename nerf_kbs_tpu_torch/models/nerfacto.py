"""nerfacto: proposal chain -> field -> composite, at eval and in training,
with the training losses.

The forward takes the JAX package's route. The Fourier field with neither
normals nor a disabled contraction runs the fused path: coordinate-major
positions through the hand-written kernels (``models.fields``' ``_t``
functions). Every other config runs the non-fused path: point-major
positions, any encoding (hash grid, CP line grid, Fourier features), plain
MLPs, the renderer heads, and with ``predict_normals`` the analytic and the
predicted normals and their losses. The config picks the path; a failure
never does.

Covered: both paths, the 'last_sample' / 'white' / 'black' backgrounds,
appearance embeddings, the semantic head, the camera optimizer ('SO3xR3':
per-camera SE(3) tangents, ``camera_deltas``, with their L2 regularizer),
and the rgb (masked when ``use_mask``), interlevel, distortion,
orientation, predicted-normal, depth, semantic, flow and sky losses. The
config carries every field of the JAX package's, with its names and
defaults, so that one override path means the same in both.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from nerf_kbs_tpu_torch.cameras.cameras import RayBundle
from nerf_kbs_tpu_torch.cameras.transforms import exp_map_se3
from nerf_kbs_tpu_torch.device import resolve_device
from nerf_kbs_tpu_torch.models.fields import (
    DensityFieldConfig,
    NerfactoFieldConfig,
    density_field_apply,
    density_field_apply_t,
    density_field_init,
    nerfacto_field_apply,
    nerfacto_field_apply_t,
    nerfacto_field_init,
)
from nerf_kbs_tpu_torch.ops import losses as L
from nerf_kbs_tpu_torch.ops import rendering as R
from nerf_kbs_tpu_torch.ops.encoding import (
    CPEncodingConfig,
    FourierEncodingConfig,
    HashEncodingConfig,
    fourier_window,
)
from nerf_kbs_tpu_torch.ops.metrics import masked_psnr
from nerf_kbs_tpu_torch.ops.samplers import RaySamples, anneal_schedule, proposal_sample


@dataclasses.dataclass(frozen=True)
class NerfactoConfig:
    """The JAX package's NerfactoConfig, field for field."""

    num_images: int = 1
    field_type: str = "hash"  # hash | fourier | cp
    fourier_num_levels: int = 8
    fourier_features_per_level: int = 32
    fourier_basis: str = "sincos"
    proposal_fourier_basis: str = "tri"
    proposal_fourier_features_per_level: int = 16
    cp_features_per_level: int = 16
    proposal_cp_features_per_level: int = 8
    fourier_anneal_steps: int = 5000
    near_plane: float = 0.001
    far_plane: float = 1000.0
    background_color: str = "last_sample"
    hidden_dim: int = 64
    num_layers: int = 2
    hidden_dim_color: int = 64
    hidden_dim_transient: int = 64
    num_levels: int = 16
    base_res: int = 16
    max_res: int = 2048
    log2_hashmap_size: int = 19
    features_per_level: int = 2
    num_proposal_samples_per_ray: Tuple[int, ...] = (256, 96)
    num_nerf_samples_per_ray: int = 48
    num_proposal_iterations: int = 2
    proposal_hidden_dim: int = 16
    proposal_log2_hashmap_size: int = 17
    proposal_num_levels: int = 5
    proposal_max_res: Tuple[int, ...] = (128, 256)
    proposal_initial_sampler: str = "piecewise"
    interlevel_loss_mult: float = 1.0
    # the interlevel loss on the first `fraction` of the ray batch only (rays
    # are i.i.d. pixel samples, so a prefix is an unbiased subsample)
    interlevel_ray_fraction: float = 1.0
    distortion_loss_mult: float = 0.002
    orientation_loss_mult: float = 0.0001
    pred_normal_loss_mult: float = 0.001
    use_proposal_weight_anneal: bool = True
    use_average_appearance_embedding: bool = True
    proposal_weights_anneal_slope: float = 10.0
    proposal_weights_anneal_max_num_iters: int = 1000
    use_single_jitter: bool = True
    # detach every PDF resample: the proposal nets learn only through the
    # interlevel loss and no field needs a position gradient
    stop_grad_sampling: bool = False
    predict_normals: bool = False
    disable_scene_contraction: bool = False
    # the semantics composite takes the weights detached unless this is set
    pass_semantic_gradients: bool = False
    mono_depth_loss_mult: float = 0.01
    # False: the depth target is z-depth, scaled by |direction| to the ray
    # distance and compared scale-and-shift invariantly; True: metric MSE
    is_euclidean_depth: bool = False
    use_depth: bool = False
    use_semantic: bool = False
    use_mask: bool = False
    semantic_loss_weight: float = 0.001
    # the L1 between the flow that the rendered depth induces in the
    # forward neighbour and the stored flow, when the batch carries the
    # stream's flow rows ('forward_flow', 'fwd_w2c', 'fwd_K', 'pixel_xy')
    flow_loss_mult: float = 0.0
    # the accumulation pushed to 0 on the batch's 'sky' rows
    sky_loss_mult: float = 0.0
    num_semantic_classes: int = 0
    appearance_embedding_dim: int = 32
    compute_dtype: str = "float32"
    # 'off' or 'SO3xR3': per-camera 6-DoF tangents applied to c2w at ray
    # generation, with L2 penalties on their translation and rotation parts
    camera_optimizer: str = "off"
    camera_opt_trans_penalty: float = 1e-2
    camera_opt_rot_penalty: float = 1e-3

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
            cp=CPEncodingConfig(
                num_levels=self.fourier_num_levels,
                features_per_level=self.cp_features_per_level,
                base_resolution=self.base_res,
                max_resolution=self.max_res,
            ),
            hash=HashEncodingConfig(
                num_levels=self.num_levels,
                features_per_level=self.features_per_level,
                log2_hashmap_size=self.log2_hashmap_size,
                base_resolution=self.base_res,
                max_resolution=self.max_res,
            ),
            hidden_dim=self.hidden_dim,
            num_layers=self.num_layers,
            hidden_dim_color=self.hidden_dim_color,
            hidden_dim_transient=self.hidden_dim_transient,
            appearance_embedding_dim=self.appearance_embedding_dim,
            use_average_appearance_embedding=self.use_average_appearance_embedding,
            use_semantics=self.use_semantic,
            num_semantic_classes=self.num_semantic_classes,
            use_pred_normals=self.predict_normals,
            disable_scene_contraction=self.disable_scene_contraction,
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
            cp=CPEncodingConfig(
                num_levels=self.proposal_num_levels,
                features_per_level=self.proposal_cp_features_per_level,
                base_resolution=16,
                max_resolution=self.proposal_max_res[i],
            ),
            hash=HashEncodingConfig(
                num_levels=self.proposal_num_levels,
                features_per_level=2,
                log2_hashmap_size=self.proposal_log2_hashmap_size,
                base_resolution=16,
                max_resolution=self.proposal_max_res[i],
            ),
            hidden_dim=self.proposal_hidden_dim,
            disable_scene_contraction=self.disable_scene_contraction,
            compute_dtype=self.compute_dtype,
        )


def init(cfg: NerfactoConfig, seed: int = 0, device=None) -> dict:
    """Parameters from ``seed`` (drawn on the CPU with one torch.Generator,
    then moved): {"fields": {...}, "proposal_networks": [{...}, ...]} and,
    with the camera optimizer, "camera_opt": zeros (num_images, 6)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    params = {
        "fields": nerfacto_field_init(cfg.field, g, dev),
        "proposal_networks": [
            density_field_init(cfg.proposal_field(i), g, dev)
            for i in range(cfg.num_proposal_iterations)
        ],
    }
    if cfg.camera_optimizer != "off":
        params["camera_opt"] = torch.zeros(cfg.num_images, 6, device=dev)
    return params


def param_groups(params: dict) -> dict:
    """Optimizer groups: the top-level entries, 'fields',
    'proposal_networks' and, with the camera optimizer, 'camera_opt'."""
    return {k: params[k] for k in params}


def camera_deltas(params: dict):
    """(N, 3, 4) per-camera pose adjustments for ``generate_rays``, or None
    without the camera optimizer."""
    if "camera_opt" not in params:
        return None
    return exp_map_se3(params["camera_opt"])


def uses_fused_path(cfg: NerfactoConfig, compute_normals: bool | None = None) -> bool:
    """The JAX package's route: the fused kernels take the Fourier field
    with the scene contraction and no normals; everything else runs the
    non-fused path."""
    compute_normals = cfg.predict_normals if compute_normals is None else compute_normals
    return (cfg.field_type == "fourier" and not cfg.predict_normals and not compute_normals
            and not cfg.disable_scene_contraction)


def windows(cfg: NerfactoConfig, step: float, device):
    """The coarse-to-fine windows of the field and of each proposal field at
    ``step`` (fully open when ``fourier_anneal_steps <= 0``); None for the
    other encodings."""
    if cfg.field_type != "fourier":
        return None, [None] * cfg.num_proposal_iterations
    if cfg.fourier_anneal_steps > 0:
        progress = min(max(float(step) / cfg.fourier_anneal_steps, 0.0), 1.0)
    else:
        progress = 1.0
    return (fourier_window(cfg.field.fourier, progress, device),
            [fourier_window(cfg.proposal_field(i).fourier, progress, device)
             for i in range(cfg.num_proposal_iterations)])


def proposal_anneal(cfg: NerfactoConfig, step: float, train: bool) -> float:
    """The proposal weights' exponent at ``step`` (1 at eval)."""
    if cfg.use_proposal_weight_anneal and train:
        return anneal_schedule(step, cfg.proposal_weights_anneal_max_num_iters,
                               cfg.proposal_weights_anneal_slope)
    return 1.0


def forward(
    params: dict,
    cfg: NerfactoConfig,
    rays: RayBundle,
    step: float = 0,
    train: bool = False,
    generator: torch.Generator | None = None,
    jitters=None,
    compute_normals: bool | None = None,
) -> dict:
    """Render a batch of rays (R,): 'rgb' (R, 3), 'accumulation', 'depth'
    (median), 'expected_depth', 'prop_depth_i', 'directions_norm' (R, 1),
    'weights' (R, S), 'ray_samples', 'proposal_history', '_view_dirs' and
    '_origins' (R, 3) and, with semantics, 'semantics' (R, C) composited
    logits. ``compute_normals`` (default: ``predict_normals``) adds 'normals'
    (R, 3) and the per-sample '_sample_normals'; ``predict_normals`` adds
    'pred_normals' and '_sample_pred_normals'. With ``train`` the samplers
    jitter (from ``generator``, or from ``jitters``: one tensor per sampler
    call, see ``proposal_sample``), the proposal weights are annealed by
    ``step``, appearance rows are per camera and, with the camera
    optimizer, '_camera_opt_tangent' is the (N, 6) tangents for the loss's
    regularizer."""
    rays = R.near_far_collider(rays, cfg.near_plane, cfg.far_plane)
    dev = rays.origins.device
    compute_normals = cfg.predict_normals if compute_normals is None else compute_normals
    use_fused = uses_fused_path(cfg, compute_normals)

    field_window, prop_windows = windows(cfg, step, dev)
    prop_cfgs = [cfg.proposal_field(i) for i in range(cfg.num_proposal_iterations)]
    anneal = proposal_anneal(cfg, step, train)
    props = params["proposal_networks"]
    cam_on = cfg.camera_optimizer != "off"
    if use_fused:
        # positions are constants when sampling is detached and the rays do
        # not depend on parameters: the backward kernels then form no dx.
        # Round 0 samples are uniform, so only the camera optimizer moves
        # them.
        need_dx = [cam_on] + [cam_on or not cfg.stop_grad_sampling] * (
            cfg.num_proposal_iterations - 1)
        density_fns = [
            (lambda pos_t, p=props[i], c=prop_cfgs[i], w=prop_windows[i], nd=need_dx[i]:
             density_field_apply_t(p, c, pos_t, window=w, need_dx=nd))
            for i in range(cfg.num_proposal_iterations)
        ]
        positions_of = lambda s: s.positions_t(rays)  # noqa: E731
    else:
        density_fns = [
            (lambda pos, p=props[i], c=prop_cfgs[i], w=prop_windows[i]:
             density_field_apply(p, c, pos, window=w))
            for i in range(cfg.num_proposal_iterations)
        ]
        positions_of = None
    samples, history = proposal_sample(
        rays,
        density_fns,
        cfg.num_proposal_samples_per_ray,
        cfg.num_nerf_samples_per_ray,
        spacing=cfg.proposal_initial_sampler,
        anneal=anneal,
        generator=generator if train else None,
        single_jitter=cfg.use_single_jitter,
        jitters=jitters if train else None,
        stop_grad=cfg.stop_grad_sampling,
        positions_of=positions_of,
    )
    if use_fused:
        field_out = nerfacto_field_apply_t(
            params["fields"], cfg.field, samples.positions_t(rays), rays.directions,
            rays.camera_indices, train=train, window=field_window,
            need_dx=cam_on or not cfg.stop_grad_sampling,
        )
    else:
        field_out = nerfacto_field_apply(
            params["fields"], cfg.field, samples.positions(rays), rays.directions,
            rays.camera_indices, train=train, compute_normals=compute_normals,
            window=field_window,
        )
    weights = R.render_weights(field_out["density"], samples.deltas)

    if use_fused:
        # composite in the transposed layout: rgb_t (3, R, S), weights (R, S)
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
        rgb = comp + bg * (1.0 - acc)
    else:
        rgb = R.render_rgb(weights, field_out["rgb"], cfg.background_color)

    outputs = {
        "rgb": rgb,
        "accumulation": R.render_accumulation(weights),
        "depth": R.render_median_depth(weights, samples),
        "expected_depth": R.render_expected_depth(weights, samples),
        "weights": weights,
        "ray_samples": samples,
        "proposal_history": history,
        "directions_norm": rays.directions_norm,
    }
    if cfg.use_semantic:
        if use_fused:
            w_sem = weights if cfg.pass_semantic_gradients else weights.detach()
            outputs["semantics"] = torch.einsum("rs,crs->rc", w_sem, field_out["semantics_t"])
        else:
            outputs["semantics"] = R.render_semantics(weights, field_out["semantics"],
                                                      cfg.pass_semantic_gradients)
    if "normals" in field_out:
        outputs["normals"] = R.render_normals(weights, field_out["normals"])
        outputs["_sample_normals"] = field_out["normals"]
    if "pred_normals" in field_out:
        outputs["pred_normals"] = R.render_normals(weights, field_out["pred_normals"])
        outputs["_sample_pred_normals"] = field_out["pred_normals"]
    for i, (ps, pw) in enumerate(history):
        outputs[f"prop_depth_{i}"] = R.render_median_depth(pw, ps)
    outputs["_view_dirs"] = rays.directions
    outputs["_origins"] = rays.origins
    if train and "camera_opt" in params:
        outputs["_camera_opt_tangent"] = params["camera_opt"]
    return outputs


def _first_rays(samples: RaySamples, n: int) -> RaySamples:
    return RaySamples(**{f.name: getattr(samples, f.name)[:n]
                         for f in dataclasses.fields(samples)})


def _first_ray_args(outputs: dict, n_rays: int, fraction: float):
    """The interlevel loss's inputs, on the first ``fraction`` of the rays
    (rays are i.i.d. pixel draws, so a prefix is an unbiased subsample)."""
    samples, weights = outputs["ray_samples"], outputs["weights"]
    history = outputs["proposal_history"]
    if fraction < 1.0:
        n = max(1, int(n_rays * fraction))
        samples, weights = _first_rays(samples, n), weights[:n]
        history = [(_first_rays(ps, n), pw[:n]) for ps, pw in history]
    return samples, weights, history


def masked_rgb_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The per-element mean over supervised pixels (mask (R, 1) weights)."""
    m = mask.to(pred.dtype)
    return torch.sum(m * (pred - gt) ** 2) / torch.clamp_min(torch.sum(m) * 3.0, 1.0)


def depth_loss(cfg: NerfactoConfig, outputs: dict, batch: dict) -> torch.Tensor:
    """The depth term (times ``mono_depth_loss_mult``): z-depth targets are
    scaled by |direction| to ray distances and compared scale-and-shift
    invariantly; euclidean targets by their MSE; masked by batch['mask']."""
    gt_depth, mask = batch["depth_image"], batch.get("mask")
    if cfg.is_euclidean_depth:
        dl = L.euclidean_depth_loss(outputs["depth"], gt_depth, mask)
    else:
        dl = L.monodepth_loss(outputs["depth"], gt_depth * outputs["directions_norm"], mask)
    return cfg.mono_depth_loss_mult * dl


def camera_opt_regularizer(cfg: NerfactoConfig, outputs: dict) -> dict:
    """{'camera_opt_regularizer': the penalties times the mean squared
    translation and rotation tangents} when the forward gave the tangents
    and a penalty is set, else {}. Squared norms are differentiable at the
    zero start."""
    if "_camera_opt_tangent" not in outputs or not (
            cfg.camera_opt_trans_penalty > 0 or cfg.camera_opt_rot_penalty > 0):
        return {}
    t = outputs["_camera_opt_tangent"]
    return {"camera_opt_regularizer":
            cfg.camera_opt_trans_penalty * torch.mean(torch.sum(t[:, :3] ** 2, -1))
            + cfg.camera_opt_rot_penalty * torch.mean(torch.sum(t[:, 3:] ** 2, -1))}


def loss(cfg: NerfactoConfig, outputs: dict, batch: dict, train: bool = True):
    """(total, metrics): the rgb MSE against batch['image'] (R, 3), over the
    pixels of batch['mask'] (R, 1) when ``use_mask``, and in training the
    interlevel loss (on the first ``interlevel_ray_fraction`` of the rays),
    the distortion loss, the camera optimizer's regularizer, with
    ``predict_normals`` the orientation and predicted-normal losses, the
    semantic cross-entropy against batch['semantics_label'] (R,), the flow
    loss against batch['forward_flow'] (R, 2) (masked by 'flow_valid'), the
    depth loss against batch['depth_image'] (R, 1) and the sky term on
    batch['sky'] (R, 1), each times its multiplier; the interlevel,
    distortion, flow and sky terms are skipped when theirs is 0. metrics
    holds every term and 'psnr' (over the masked pixels when
    ``use_mask``)."""
    gt, pred = batch["image"], outputs["rgb"]
    masked = cfg.use_mask and "mask" in batch
    rgb_loss = masked_rgb_loss(pred, gt, batch["mask"]) if masked else L.mse_loss(pred, gt)
    losses = {"rgb_loss": rgb_loss}
    if train:
        if cfg.interlevel_loss_mult > 0:
            losses["interlevel_loss"] = cfg.interlevel_loss_mult * L.interlevel_loss(
                *_first_ray_args(outputs, gt.shape[0], cfg.interlevel_ray_fraction))
        if cfg.distortion_loss_mult > 0:
            losses["distortion_loss"] = cfg.distortion_loss_mult * L.distortion_loss(
                outputs["ray_samples"], outputs["weights"])
        losses.update(camera_opt_regularizer(cfg, outputs))
        if cfg.predict_normals and "_sample_normals" in outputs:
            losses["orientation_loss"] = cfg.orientation_loss_mult * L.orientation_loss(
                outputs["weights"], outputs["_sample_normals"], outputs["_view_dirs"])
            # the predicted normals follow the analytic ones, not the reverse
            losses["pred_normal_loss"] = cfg.pred_normal_loss_mult * L.pred_normal_loss(
                outputs["weights"], outputs["_sample_normals"].detach(),
                outputs["_sample_pred_normals"])
        if cfg.use_semantic and "semantics_label" in batch:
            losses["semantic_loss"] = cfg.semantic_loss_weight * L.semantic_loss(
                outputs["semantics"], batch["semantics_label"])
        if cfg.flow_loss_mult > 0.0 and "forward_flow" in batch:
            pred_flow = L.induced_flow(outputs["_origins"], outputs["_view_dirs"],
                                       outputs["depth"], batch["pixel_xy"], batch["fwd_w2c"],
                                       batch["fwd_K"])
            losses["flow_loss"] = cfg.flow_loss_mult * L.flow_loss(
                pred_flow, batch["forward_flow"], batch.get("flow_valid"))
        if cfg.use_depth and "depth_image" in batch:
            losses["depth_loss"] = depth_loss(cfg, outputs, batch)
        if cfg.sky_loss_mult > 0.0 and "sky" in batch:
            sky = batch["sky"].to(pred.dtype)
            acc = outputs["accumulation"]
            losses["sky_loss"] = cfg.sky_loss_mult * (
                torch.sum(sky * acc**2) / torch.clamp_min(torch.sum(sky), 1.0))
    total = sum(losses.values())
    if masked:
        psnr = masked_psnr(pred.detach(), gt, batch["mask"][..., 0])
    else:
        psnr = 10.0 * torch.log10(1.0 / torch.clamp_min(L.mse_loss(pred, gt).detach(), 1e-12))
    return total, {"psnr": psnr, **losses}
