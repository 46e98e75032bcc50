"""monodepth2's depth and pose networks (the JAX package's
``process_data/networks/monodepth2.py``): a ResNet-18 encoder and a U-Net
decoder of sigmoid disparities at 4 scales; a ResNet-18 over a stacked frame
pair and a pose decoder of an axis-angle and a translation.
``load_monodepth2_weights`` reads the public checkpoint directory
(``encoder.pth``, ``depth.pth``, ``pose_encoder.pth``, ``pose.pth``)."""

from __future__ import annotations

import re
from pathlib import Path
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from nerf_kbs_tpu_torch.process_data.networks.resnet import ResNetEncoder


def _reflect_conv(conv: nn.Conv2d, x):
    return conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))


class ConvBlock(nn.Module):
    """Reflect pad, 3x3 VALID convolution, ELU: the decoder's unit."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, 3)

    def forward(self, x):
        return F.elu(_reflect_conv(self.conv, x))


class DepthDecoder(nn.Module):
    """The encoder's pyramid -> {scale: sigmoid disparity (B, H_s, W_s)} for
    scales 0..3, scale 0 at the input's resolution."""

    def __init__(self, num_ch_enc: Sequence[int] = (64, 64, 128, 256, 512),
                 num_ch_dec: Sequence[int] = (16, 32, 64, 128, 256),
                 scales: Sequence[int] = (0, 1, 2, 3)):
        super().__init__()
        self.scales = tuple(scales)
        in_ch = num_ch_enc[-1]
        for i in range(4, -1, -1):
            self.add_module(f"upconv_{i}_0", ConvBlock(in_ch, num_ch_dec[i]))
            cat = num_ch_dec[i] + (num_ch_enc[i - 1] if i > 0 else 0)
            self.add_module(f"upconv_{i}_1", ConvBlock(cat, num_ch_dec[i]))
            if i in self.scales:
                self.add_module(f"dispconv_{i}", nn.Conv2d(num_ch_dec[i], 1, 3))
            in_ch = num_ch_dec[i]

    def forward(self, feats):
        outputs = {}
        x = feats[-1]
        for i in range(4, -1, -1):
            x = F.interpolate(getattr(self, f"upconv_{i}_0")(x), scale_factor=2, mode="nearest")
            if i > 0:
                skip = feats[i - 1]
                # odd sizes: crop to the skip's
                x = torch.cat([x[:, :, :skip.shape[2], :skip.shape[3]], skip], dim=1)
            x = getattr(self, f"upconv_{i}_1")(x)
            if i in self.scales:
                outputs[i] = torch.sigmoid(_reflect_conv(getattr(self, f"dispconv_{i}"), x))[:, 0]
        return outputs


class PoseDecoder(nn.Module):
    """The last encoder feature of a stacked pair -> (axisangle (B, 3),
    translation (B, 3)), scaled by 0.01. The head predicts 6 * num_frames
    channels, as the public ``pose.pth`` does, and frame 0 is kept."""

    def __init__(self, num_frames: int = 2, in_ch: int = 512):
        super().__init__()
        self.num_frames = num_frames
        self.squeeze = nn.Conv2d(in_ch, 256, 1)
        self.pose_0 = nn.Conv2d(256, 256, 3, 1, 1)
        self.pose_1 = nn.Conv2d(256, 256, 3, 1, 1)
        self.pose_2 = nn.Conv2d(256, 6 * num_frames, 1)

    def forward(self, feat):
        x = F.relu(self.squeeze(feat))
        x = F.relu(self.pose_0(x))
        x = F.relu(self.pose_1(x))
        x = 0.01 * self.pose_2(x).mean(dim=(2, 3))
        x = x.reshape(x.shape[0], self.num_frames, 6)[:, 0]
        return x[:, :3], x[:, 3:]


class Monodepth2(nn.Module):
    """The four networks of depth and pose inference."""

    def __init__(self):
        super().__init__()
        self.encoder = ResNetEncoder()
        self.depth_decoder = DepthDecoder()
        self.pose_encoder = ResNetEncoder(num_input_images=2)
        self.pose_decoder = PoseDecoder()

    def predict_disparity(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) in [0, 1] -> full-resolution sigmoid disparity (B, H,
        W)."""
        return self.depth_decoder(self.encoder(images))[0]

    def predict_pose(self, img_a: torch.Tensor, img_b: torch.Tensor) -> torch.Tensor:
        """A frame pair (B, 3, H, W) each -> pose vector (B, 6) =
        [translation, axisangle] mapping a to b (``cameras.transforms
        .pose_vec2mat(..., "axisangle")``)."""
        feats = self.pose_encoder(torch.cat([img_a, img_b], dim=1))
        axisangle, translation = self.pose_decoder(feats[-1])
        return torch.cat([translation, axisangle], dim=-1)


# ---------------------------------------------------------------------------
# the public checkpoints
# ---------------------------------------------------------------------------


def _load(path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def resnet_state_dict(sd: dict, prefix: str = "") -> dict:
    """A torchvision-layout ResNet state dict (``conv1``, ``bn1``,
    ``layerL.B.{conv1,bn1,conv2,bn2,downsample.0,downsample.1}``, under
    ``prefix``) -> ``ResNetEncoder``'s; other keys (``fc``,
    ``num_batches_tracked``, the image size) are left out."""
    out = {}
    rename = {"downsample.0": "downsample_conv", "downsample.1": "downsample_bn"}
    for key, v in sd.items():
        if not key.startswith(prefix) or not torch.is_tensor(v):
            continue
        k = key[len(prefix):]
        m = re.fullmatch(r"layer(\d)\.(\d+)\.(conv\d|bn\d|downsample\.\d)\.(\w+)", k)
        if m:
            layer, block, part, leaf = m.groups()
            k = f"layer{layer}_{block}.{rename.get(part, part)}.{leaf}"
        elif not re.fullmatch(r"(conv1|bn1)\.\w+", k):
            continue
        if k.endswith("num_batches_tracked"):
            continue
        out[k] = v.float()
    return out


def depth_decoder_state_dict(sd: dict) -> dict:
    """The public ``depth.pth`` (``decoder.{j}.conv.conv`` in upconv order
    (4, 0), (4, 1), ..., (0, 1), then ``decoder.{10 + k}.conv`` for scales
    0..3) -> ``DepthDecoder``'s."""
    names = [f"upconv_{i}_{j}.conv" for i in range(4, -1, -1) for j in (0, 1)]
    out = {}
    for j, name in enumerate(names):
        for leaf in ("weight", "bias"):
            out[f"{name}.{leaf}"] = sd[f"decoder.{j}.conv.conv.{leaf}"].float()
    for k in range(4):
        for leaf in ("weight", "bias"):
            out[f"dispconv_{k}.{leaf}"] = sd[f"decoder.{10 + k}.conv.{leaf}"].float()
    return out


def pose_decoder_state_dict(sd: dict) -> dict:
    """The public ``pose.pth`` (``net.0`` .. ``net.3``) -> ``PoseDecoder``'s."""
    names = ("squeeze", "pose_0", "pose_1", "pose_2")
    return {f"{name}.{leaf}": sd[f"net.{i}.{leaf}"].float()
            for i, name in enumerate(names) for leaf in ("weight", "bias")}


def load_monodepth2_weights(model_dir: str) -> dict:
    """The public monodepth2 checkpoint directory -> ``Monodepth2``'s state
    dict. Both encoders' dicts may carry the official ``encoder.`` prefix or
    none (a plain torchvision dict)."""
    d = Path(model_dir)

    def resnet(name):
        sd = _load(d / name)
        return resnet_state_dict(sd, "encoder." if "encoder.conv1.weight" in sd else "")

    parts = {"encoder": resnet("encoder.pth"),
             "depth_decoder": depth_decoder_state_dict(_load(d / "depth.pth")),
             "pose_encoder": resnet("pose_encoder.pth"),
             "pose_decoder": pose_decoder_state_dict(_load(d / "pose.pth"))}
    return {f"{net}.{k}": v for net, sd in parts.items() for k, v in sd.items()}
