"""ResNet-18/34 encoder, monodepth2's backbone (the JAX package's
``process_data/networks/resnet.py``), with inference BatchNorm."""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from nerf_kbs_tpu_torch.process_data.networks import FrozenBatchNorm


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, features, 3, stride, 1, bias=False)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm(features)
        self.has_downsample = in_ch != features or stride != 1
        if self.has_downsample:
            self.downsample_conv = nn.Conv2d(in_ch, features, 1, stride, bias=False)
            self.downsample_bn = FrozenBatchNorm(features)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.has_downsample:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + x)


class ResNetEncoder(nn.Module):
    """(B, 3 * num_input_images, H, W) in [0, 1] -> the 5-scale pyramid
    [relu1 (1/2), layer1 (1/4), layer2 (1/8), layer3 (1/16), layer4
    (1/32)]; the input is normalised with (x - 0.45) / 0.225."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2), num_input_images: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(3 * num_input_images, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.block_names = []
        in_ch = 64
        for li, (n_blocks, width) in enumerate(zip(layers, (64, 128, 256, 512))):
            names = []
            for bi in range(n_blocks):
                stride = 2 if (li > 0 and bi == 0) else 1
                name = f"layer{li + 1}_{bi}"
                self.add_module(name, BasicBlock(in_ch, width, stride))
                names.append(name)
                in_ch = width
            self.block_names.append(names)

    def forward(self, x):
        x = (x - 0.45) / 0.225
        y = F.relu(self.bn1(self.conv1(x)))
        feats = [y]
        y = F.max_pool2d(y, 3, 2, 1)
        for names in self.block_names:
            for name in names:
                y = getattr(self, name)(y)
            feats.append(y)
        return feats
