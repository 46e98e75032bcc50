"""Method registry of the port: the nerfacto-tpu operating point."""

from __future__ import annotations

import dataclasses

from nerf_kbs_tpu_torch.engine.optimizers import OptimizerConfig
from nerf_kbs_tpu_torch.engine.trainer import TrainerConfig
from nerf_kbs_tpu_torch.models.nerfacto import NerfactoConfig


@dataclasses.dataclass(frozen=True)
class DataManagerConfig:
    train_num_rays_per_batch: int = 4096


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    model: NerfactoConfig
    eval_num_rays_per_chunk: int = 1 << 15
    # bf16 matrix-product inputs with f32 accumulation
    mixed_precision: bool = True
    optimizers: dict = dataclasses.field(default_factory=dict)  # group -> OptimizerConfig
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    datamanager: DataManagerConfig = DataManagerConfig()

    def model_config(self) -> NerfactoConfig:
        """The model config as the trainer runs it: bf16 compute under mixed
        precision."""
        if self.mixed_precision:
            return dataclasses.replace(self.model, compute_dtype="bfloat16")
        return self.model


def nerfacto_tpu_method() -> MethodSpec:
    """nerfacto with the Fourier-feature field: triangle-wave basis, base MLP
    (256, 128, 128, 16), rgb MLP (31, 64, 64, 3), proposals (96, 32) -> 48
    samples, no appearance embedding; detached resampling (the proposal nets
    learn through the interlevel loss alone, on half the ray batch); Adam at
    1e-3 decaying to 1e-5 over 2e6 steps with a global-norm clip of 1 per
    group; 4096 rays per batch."""
    group = OptimizerConfig(lr=1e-3, eps=1e-15, lr_final=1e-5, max_steps=2_000_000,
                            max_norm=1.0)
    return MethodSpec(
        model=NerfactoConfig(
            field_type="fourier",
            hidden_dim=128,
            num_layers=3,
            base_res=4,
            max_res=256,
            fourier_anneal_steps=5000,
            fourier_basis="tri",
            num_proposal_samples_per_ray=(96, 32),
            stop_grad_sampling=True,
            interlevel_ray_fraction=0.5,
            appearance_embedding_dim=0,
        ),
        eval_num_rays_per_chunk=1 << 15,
        mixed_precision=True,
        optimizers={"proposal_networks": group, "fields": group},
        trainer=TrainerConfig(
            method_name="nerfacto-tpu", max_num_iterations=30000, steps_per_save=2000,
            steps_per_eval_batch=500, steps_per_eval_image=500,
            eval_num_rays_per_chunk=1 << 15,
        ),
        datamanager=DataManagerConfig(train_num_rays_per_batch=4096),
    )
