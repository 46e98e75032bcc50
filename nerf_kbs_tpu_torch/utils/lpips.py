"""LPIPS: the VGG16 feature distance with learned linear heads (the JAX
package's ``utils/lpips.py``).

The trunk is torchvision's VGG16 ``features`` (13 3x3 convolutions, a 2x2
max pool before blocks 2 to 5), read from the public checkpoint; the taps
are relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3; the linear heads come
from the official lpips ``vgg.pth``, clipped at 0. The image is mapped from
[0, 1] to [-1, 1] and then by LPIPS's shift and scale. Both checkpoints are
optional: without them ``load_lpips`` returns None and eval omits the metric.

Search path: ``$NKT_LPIPS_DIR`` or ``~/.cache/nkt/lpips``, holding
``vgg16_features.pth`` (the torchvision ``features`` state dict) and
``lpips_vgg.pth`` (keys ``lin0.model.1.weight`` .. ``lin4``), the files the
JAX package reads."""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from nerf_kbs_tpu_torch.device import resolve_device

# (out_channels, max pool before the convolution)
VGG16 = ((64, False), (64, False), (128, True), (128, False), (256, True), (256, False),
         (256, False), (512, True), (512, False), (512, False), (512, True), (512, False),
         (512, False))
# the convolutions whose relu output LPIPS compares
TAPS = (1, 3, 6, 9, 12)
# each convolution's index in torchvision's vgg16().features
TORCH_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """(B, 3, H, W) -> the five tapped relu maps."""

    def __init__(self):
        super().__init__()
        convs, in_ch = [], 3
        for ch, _ in VGG16:
            convs.append(nn.Conv2d(in_ch, ch, 3, padding=1))
            in_ch = ch
        self.convs = nn.ModuleList(convs)

    def forward(self, x):
        taps = []
        for i, ((_, pool), conv) in enumerate(zip(VGG16, self.convs)):
            if pool:
                x = F.max_pool2d(x, 2, 2)
            x = F.relu(conv(x))
            if i in TAPS:
                taps.append(x)
        return taps


class LPIPS(nn.Module):
    """``lpips(pred, gt)``: (H, W, 3) images in [0, 1] -> the scalar
    distance."""

    def __init__(self, features: VGG16Features, lins: list[torch.Tensor]):
        super().__init__()
        self.features = features
        for i, w in enumerate(lins):
            self.register_buffer(f"lin{i}", w)
        self.register_buffer("shift", torch.tensor(SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(SCALE).reshape(1, 3, 1, 1))

    @torch.no_grad()
    def forward(self, pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        def feats(img):
            x = img.permute(2, 0, 1)[None].float()
            return self.features((2.0 * x - 1.0 - self.shift) / self.scale)

        total = pred.new_zeros(())
        for i, (a, b) in enumerate(zip(feats(pred), feats(gt))):
            a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
            lin = getattr(self, f"lin{i}").reshape(1, -1, 1, 1)
            total = total + torch.mean(torch.sum((a - b) ** 2 * lin, dim=1))
        return total


def checkpoint_dir() -> Path:
    return Path(os.environ.get("NKT_LPIPS_DIR", Path.home() / ".cache" / "nkt" / "lpips"))


def load_lpips(device=None) -> Optional[LPIPS]:
    """LPIPS on ``device`` (CUDA unless "cpu") from the checkpoints under
    ``checkpoint_dir()``; None when either file is absent."""
    d = checkpoint_dir()
    vgg_path, lin_path = d / "vgg16_features.pth", d / "lpips_vgg.pth"
    if not (vgg_path.exists() and lin_path.exists()):
        return None
    vgg_sd = torch.load(vgg_path, map_location="cpu", weights_only=True)
    features = VGG16Features()
    features.load_state_dict({
        f"convs.{i}.{leaf}": vgg_sd[f"features.{ti}.{leaf}"].float()
        for i, ti in enumerate(TORCH_INDEX) for leaf in ("weight", "bias")})
    lin_sd = torch.load(lin_path, map_location="cpu", weights_only=True)
    lins = [lin_sd[f"lin{i}.model.1.weight"].float()[0, :, 0, 0].clamp_min(0.0)
            for i in range(len(TAPS))]
    return LPIPS(features, lins).to(resolve_device(device)).eval()
