"""PyTorch/CUDA port of nerf_kbs_tpu for the NVIDIA H100.

The package stands beside the JAX package and imports nothing of it. Its
entry points (``models.nerfacto.init``, ``data.outputs.DataparserOutputs
.cameras``, ``engine.render.Renderer``, ``convert.params_from_jax``) run on
CUDA unless the caller passes ``device="cpu"``; on a CUDA tensor the fused
field wrappers launch the hand-written kernels in ``csrc/`` and on a CPU
tensor they run the plain PyTorch versions.

Importing the package sets ``torch.backends.cuda.matmul.allow_tf32 = False``
(and the cuDNN flag alike): the plain versions of the kernels and the f32
comparisons against them need full-f32 matrix products on the card.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
