"""Method registry of the port: the nerfacto-tpu operating point."""

from __future__ import annotations

import dataclasses

from nerf_kbs_tpu_torch.models.nerfacto import NerfactoConfig


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    model: NerfactoConfig
    eval_num_rays_per_chunk: int = 1 << 15
    # bf16 matrix-product inputs with f32 accumulation
    mixed_precision: bool = True

    def model_config(self) -> NerfactoConfig:
        """The model config as the trainer runs it: bf16 compute under mixed
        precision."""
        if self.mixed_precision:
            return dataclasses.replace(self.model, compute_dtype="bfloat16")
        return self.model


def nerfacto_tpu_method() -> MethodSpec:
    """nerfacto with the Fourier-feature field: triangle-wave basis, base MLP
    (256, 128, 128, 16), rgb MLP (31, 64, 64, 3), proposals (96, 32) -> 48
    samples, no appearance embedding."""
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
            appearance_embedding_dim=0,
        ),
        eval_num_rays_per_chunk=1 << 15,
        mixed_precision=True,
    )
