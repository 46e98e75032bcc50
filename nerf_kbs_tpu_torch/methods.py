"""Built-in methods: the JAX package's registry (``nerf_kbs_tpu/methods.py``)
name for name, with its values. All eight build and train:
``nerfacto-tpu`` and ``nerfacto-tpu-fast`` (the Fourier field on the fused
kernels); ``nerfacto``, ``nerfacto-big``, ``synthetic-nerfacto`` and
``semantic-nerfw`` as registered (the hash field on the non-fused path;
``semantic-nerfw`` also with ``--model.field_type fourier``, and with
``--model.use_transient_embedding true`` the NeRF-W transient path);
``test-nerfacto`` (the hash nerfacto over a transforms.json scene); and
``vanilla-nerf`` (coarse and fine MLPs with the temporal distortion, over a
Virtual KITTI 2 scene).
"""

from __future__ import annotations

import dataclasses

from nerf_kbs_tpu_torch.data.datamanager import DataManagerConfig
from nerf_kbs_tpu_torch.data.dataparsers.kitti import KittiDataParserConfig
from nerf_kbs_tpu_torch.data.dataparsers.transforms_json import TransformsJsonConfig
from nerf_kbs_tpu_torch.data.dataparsers.vkitti import VKittiDataParserConfig
from nerf_kbs_tpu_torch.engine.cli import MethodSpec, register_method
from nerf_kbs_tpu_torch.engine.optimizers import OptimizerConfig
from nerf_kbs_tpu_torch.engine.trainer import TrainerConfig
from nerf_kbs_tpu_torch.models.nerfacto import NerfactoConfig
from nerf_kbs_tpu_torch.models.semantic_nerfw import SemanticNerfWConfig
from nerf_kbs_tpu_torch.models.vanilla_nerf import VanillaNerfConfig


def vanilla_nerf_method() -> MethodSpec:
    """Vanilla NeRF with the temporal distortion over vKITTI 2: RAdam at 5e-4
    (fields) and 1e-3 (temporal distortion), each group's gradient clipped
    to a global norm of 1."""
    return MethodSpec(
        model_name="vanilla_nerf",
        model=VanillaNerfConfig(enable_temporal_distortion=True),
        trainer=TrainerConfig(method_name="vanilla-nerf", max_num_iterations=30000,
                              mixed_precision=False, eval_num_rays_per_chunk=1 << 14),
        optimizers={
            "fields": OptimizerConfig(optimizer="radam", lr=5e-4, eps=1e-8, max_norm=1.0),
            "temporal_distortion": OptimizerConfig(optimizer="radam", lr=1e-3, eps=1e-8,
                                                   max_norm=1.0),
        },
        dataparser=VKittiDataParserConfig(),
        datamanager=DataManagerConfig(train_num_rays_per_batch=4096),
        description="classic NeRF w/ temporal distortion over vKITTI",
    )


def nerfacto_method() -> MethodSpec:
    group = OptimizerConfig(lr=1e-3, eps=1e-15, lr_final=1e-5, max_steps=2_000_000)
    return MethodSpec(
        model_name="nerfacto",
        model=NerfactoConfig(),
        trainer=TrainerConfig(method_name="nerfacto", max_num_iterations=30000,
                              steps_per_save=2000, steps_per_eval_batch=500,
                              steps_per_eval_image=500, mixed_precision=False,
                              eval_num_rays_per_chunk=1 << 15),
        optimizers={"proposal_networks": group, "fields": group},
        dataparser=KittiDataParserConfig(),
        datamanager=DataManagerConfig(train_num_rays_per_batch=4096),
        description="hash-grid NeRF on KITTI odometry",
    )


def nerfacto_big_method() -> MethodSpec:
    spec = nerfacto_method()
    spec.model = dataclasses.replace(spec.model, num_nerf_samples_per_ray=128,
                                     num_proposal_samples_per_ray=(512, 256), hidden_dim=128,
                                     hidden_dim_color=128, max_res=4096, log2_hashmap_size=21)
    spec.trainer = dataclasses.replace(spec.trainer, method_name="nerfacto-big",
                                       max_num_iterations=100000)
    spec.description = "the nerfacto-big preset"
    return spec


def semantic_nerfw_method() -> MethodSpec:
    return MethodSpec(
        model_name="semantic_nerfw",
        model=SemanticNerfWConfig(use_semantic=True, use_depth=True, use_mask=True,
                                  mono_depth_loss_mult=0.001, semantic_loss_weight=0.05),
        trainer=TrainerConfig(method_name="semantic-nerfw", max_num_iterations=30000,
                              steps_per_save=2000, steps_per_eval_batch=500,
                              steps_per_eval_image=500, steps_per_eval_all_images=10000,
                              mixed_precision=True, eval_num_rays_per_chunk=1 << 16),
        optimizers={"proposal_networks": OptimizerConfig(lr=1e-3, eps=1e-15),
                    "fields": OptimizerConfig(lr=1e-3, eps=1e-15)},
        dataparser=KittiDataParserConfig(first_frame=5, last_frame=120,
                                         train_split_fraction=0.75, use_depth=True),
        datamanager=DataManagerConfig(train_num_rays_per_batch=4096),
        description="semantic NeRF-W on KITTI w/ depth+semantics+masks",
    )


def test_nerfacto_method() -> MethodSpec:
    spec = nerfacto_method()
    spec.trainer = dataclasses.replace(spec.trainer, method_name="test-nerfacto",
                                       max_num_iterations=20000, steps_per_eval_image=5000,
                                       steps_per_eval_batch=5000, mixed_precision=True)
    spec.dataparser = TransformsJsonConfig(train_split_fraction=0.75)
    spec.description = "nerfacto over transforms.json scenes"
    return spec


def nerfacto_tpu_method() -> MethodSpec:
    """nerfacto with the Fourier-feature field: triangle-wave basis, base MLP
    (256, 128, 128, 16), rgb MLP (31, 64, 64, 3), proposals (96, 32) -> 48
    samples, no appearance embedding; detached resampling (the proposal nets
    learn through the interlevel loss alone, on half the ray batch); Adam at
    1e-3 decaying to 1e-5 over 2e6 steps with a global-norm clip of 1 per
    group; 4096 rays per batch; bf16 on the card."""
    spec = nerfacto_method()
    spec.model = dataclasses.replace(
        spec.model, field_type="fourier", hidden_dim=128, num_layers=3, base_res=4, max_res=256,
        fourier_anneal_steps=5000, fourier_basis="tri", num_proposal_samples_per_ray=(96, 32),
        stop_grad_sampling=True, interlevel_ray_fraction=0.5, appearance_embedding_dim=0)
    spec.optimizers = {g: dataclasses.replace(c, max_norm=1.0) for g, c in spec.optimizers.items()}
    spec.trainer = dataclasses.replace(spec.trainer, method_name="nerfacto-tpu",
                                       mixed_precision=True)
    spec.description = "nerfacto with the Fourier field on the fused kernels"
    return spec


def nerfacto_tpu_fast_method() -> MethodSpec:
    """nerfacto-tpu with one proposal round (96,) and 32 samples, the
    interlevel loss on a quarter of the batch."""
    spec = nerfacto_tpu_method()
    spec.model = dataclasses.replace(spec.model, num_proposal_samples_per_ray=(96,),
                                     num_proposal_iterations=1, proposal_max_res=(256,),
                                     num_nerf_samples_per_ray=32, interlevel_ray_fraction=0.25)
    spec.trainer = dataclasses.replace(spec.trainer, method_name="nerfacto-tpu-fast")
    spec.description = "nerfacto-tpu speed preset (1 proposal round, 32 samples)"
    return spec


def synthetic_nerfacto_method() -> MethodSpec:
    spec = nerfacto_method()
    spec.model = dataclasses.replace(spec.model, num_levels=8, max_res=256, log2_hashmap_size=15,
                                     near_plane=0.05, far_plane=8.0, appearance_embedding_dim=0)
    spec.trainer = dataclasses.replace(spec.trainer, method_name="synthetic-nerfacto",
                                       max_num_iterations=2000, steps_per_eval_image=500,
                                       eval_num_rays_per_chunk=1 << 13)
    spec.dataparser = None
    spec.datamanager = DataManagerConfig(train_num_rays_per_batch=1024)
    spec.description = "nerfacto on the analytic sphere scene"
    return spec


register_method("vanilla-nerf", vanilla_nerf_method)
register_method("nerfacto-tpu", nerfacto_tpu_method)
register_method("nerfacto", nerfacto_method)
register_method("nerfacto-big", nerfacto_big_method)
register_method("semantic-nerfw", semantic_nerfw_method)
register_method("test-nerfacto", test_nerfacto_method)
register_method("nerfacto-tpu-fast", nerfacto_tpu_fast_method)
register_method("synthetic-nerfacto", synthetic_nerfacto_method)
