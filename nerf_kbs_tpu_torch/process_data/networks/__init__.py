"""The preprocessing networks as ``nn.Module``s in NCHW: the ResNet encoder
and monodepth2's depth and pose nets, RAFT, the instance segmenter and the
inpainting generator (the JAX package's ``process_data/networks/``). Each
module's parameter names follow the flax module's, so that
``process_data.convert`` carries JAX variables across by name.

``init_weights`` gives a module seeded weights from a ``torch.Generator``,
from the same families as flax's defaults (LeCun-normal kernels, zero
biases, unit norm scales); the numbers differ from a JAX seed's.

``deterministic_convolutions`` scopes cuDNN to its deterministic
algorithms; the three trainers' steps run under it. ``pad_edge`` is
``F.pad``'s "replicate" at the far end with a backward in a fixed order."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm over channel dim 1 with stored statistics
    (epsilon 1e-5, as flax's)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=self.eps)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded weights for every convolution and linear layer of ``module``:
    kernels from N(0, 1 / fan_in), biases 0; norms keep their unit scale
    and zero bias. Draws on the CPU in module order, then copies."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            w = torch.empty(m.weight.shape).normal_(0.0, 1.0 / math.sqrt(fan_in),
                                                    generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
    return module


@contextlib.contextmanager
def deterministic_convolutions():
    """cuDNN restricted to deterministic algorithms, and not benchmarking,
    for the duration; the previous settings come back after. A training
    step's convolution backwards then repeat their bits (cuDNN's fastest
    backward algorithms may add with atomics). Only the deterministic and
    benchmark flags change: ``torch.backends.cudnn.flags`` would also set
    every other flag (cuDNN on or off, TF32) to its own defaults."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def pad_edge(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """x with n copies of its last slice along ``dim`` appended (``F.pad``'s
    "replicate" at the far end of one dimension). The copies' gradients sum
    in a reduction, where ``replication_pad2d``'s backward adds with atomics
    on the card."""
    if n == 0:
        return x
    shape = list(x.shape)
    shape[dim] = n
    return torch.cat([x, x.narrow(dim, x.shape[dim] - 1, 1).expand(shape)], dim)
