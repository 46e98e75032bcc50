"""RAFT optical flow (the JAX package's ``process_data/networks/raft.py``):
instance-normed feature and context encoders at 1/8 resolution, the
all-pairs 4-level correlation pyramid, radius-4 lookups, the SepConvGRU
update block and convex 8x upsampling, refined ``iters`` times in a Python
loop (``lax.scan`` in JAX).

``convex_upsample`` lays the 8 x 8 children of a coarse pixel out as the
published RAFT does: row 8i + u, column 8j + v. The JAX package's
transposition scrambles them (its columns mix the x and y flow)."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from nerf_kbs_tpu_torch.parallel.mesh import batch_sum
from nerf_kbs_tpu_torch.process_data.warp import grid_sample_bilinear


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalisation over (H, W): biased variance,
    epsilon 1e-5, then an affine scale and bias."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias, eps=1e-5)


class ResidualBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, features, 3, stride, 1)
        self.norm1 = InstanceNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1)
        self.norm2 = InstanceNorm(features)
        self.has_downsample = stride != 1 or in_ch != features
        if self.has_downsample:
            self.downsample_conv = nn.Conv2d(in_ch, features, 1, stride)
            self.norm3 = InstanceNorm(features)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.has_downsample:
            x = self.norm3(self.downsample_conv(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """(B, 3, H, W) -> (B, out_dim, H/8, W/8)."""

    def __init__(self, out_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        self.norm1 = InstanceNorm(64)
        in_ch = 64
        for i, (feat, stride) in enumerate([(64, 1), (64, 1), (96, 2), (96, 1), (128, 2),
                                            (128, 1)]):
            self.add_module(f"res_{i}", ResidualBlock(in_ch, feat, stride))
            in_ch = feat
        self.conv2 = nn.Conv2d(128, out_dim, 1)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        for i in range(6):
            y = getattr(self, f"res_{i}")(y)
        return self.conv2(y)


class SepConvGRU(nn.Module):
    """A GRU over a 1x5 then a 5x1 convolution."""

    def __init__(self, hidden: int = 128, input_dim: int = 256):
        super().__init__()
        for tag, k, pad in (("horiz", (1, 5), (0, 2)), ("vert", (5, 1), (2, 0))):
            for g in ("z", "r", "q"):
                self.add_module(f"conv{g}_{tag}", nn.Conv2d(hidden + input_dim, hidden, k, 1, pad))

    def forward(self, h, x):
        for tag in ("horiz", "vert"):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz_{tag}")(hx))
            r = torch.sigmoid(getattr(self, f"convr_{tag}")(hx))
            q = torch.tanh(getattr(self, f"convq_{tag}")(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class MotionEncoder(nn.Module):
    def __init__(self, corr_channels: int = 4 * 81):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_channels, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, 1, 1)
        self.convf1 = nn.Conv2d(2, 128, 7, 1, 3)
        self.convf2 = nn.Conv2d(128, 64, 3, 1, 1)
        self.conv = nn.Conv2d(256, 128 - 2, 3, 1, 1)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([out, flow], dim=1)


class UpdateBlock(nn.Module):
    def __init__(self, hidden: int = 128, context: int = 128, corr_channels: int = 4 * 81):
        super().__init__()
        self.encoder = MotionEncoder(corr_channels)
        self.gru = SepConvGRU(hidden, context + 128)
        self.flow_head_conv1 = nn.Conv2d(hidden, 256, 3, 1, 1)
        self.flow_head_conv2 = nn.Conv2d(256, 2, 3, 1, 1)
        self.mask_conv1 = nn.Conv2d(hidden, 256, 3, 1, 1)
        self.mask_conv2 = nn.Conv2d(256, 64 * 9, 1)

    def forward(self, h, context, corr, flow):
        """-> (hidden, 0.25 * upsampling mask (B, 576, h, w), flow update
        (B, 2, h, w) as (dx, dy))."""
        inp = torch.cat([context, self.encoder(flow, corr)], dim=1)
        h = self.gru(h, inp)
        df = self.flow_head_conv2(F.relu(self.flow_head_conv1(h)))
        mask = self.mask_conv2(F.relu(self.mask_conv1(h)))
        return h, 0.25 * mask, df


def correlation_pyramid(f1: torch.Tensor, f2: torch.Tensor, num_levels: int = 4) -> list:
    """All-pairs correlation of (B, C, h, w) features / sqrt(C), as (B*h*w,
    1, h, w) images of f2's grid, 2x2-average-pooled (floor) per level; a
    level pooled below one pixel is empty, as flax's pool leaves it."""
    b, c, h, w = f1.shape
    corr = torch.bmm(f1.reshape(b, c, h * w).transpose(1, 2), f2.reshape(b, c, h * w))
    corr = (corr / torch.sqrt(torch.tensor(float(c)))).reshape(b * h * w, 1, h, w)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        hl, wl = corr.shape[2] // 2, corr.shape[3] // 2
        corr = F.avg_pool2d(corr, 2, 2) if hl and wl else corr.new_zeros(b * h * w, 1, hl, wl)
        pyramid.append(corr)
    return pyramid


def lookup_corr(pyramid: list, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Sample each level in a (2r+1)^2 window around ``coords`` (B, 2, h, w),
    the current correspondences in 1/8-resolution pixels as (y, x). ->
    (B, levels * (2r+1)^2, h, w): channels by level, then by the window's
    row offset dy, with its column offset dx inside (the JAX package's
    order, which ``convc1``'s input channels follow)."""
    b, _, h, w = coords.shape
    r = radius
    ar = torch.arange(-r, r + 1.0, device=coords.device)
    delta = torch.stack(torch.meshgrid(ar, ar, indexing="ij"), -1).reshape(-1, 2)  # (dy, dx)
    k = delta.shape[0]
    centre = coords.permute(0, 2, 3, 1).reshape(b * h * w, 1, 2)
    out = []
    for lvl, corr in enumerate(pyramid):
        if corr.numel() == 0:  # every tap of an empty level is outside
            out.append(coords.new_zeros(b, k, h, w))
            continue
        cc = centre / (2.0**lvl) + delta[None]  # (BHW, K, (y, x))
        uv = cc.flip(-1).permute(0, 2, 1)[..., None]  # the sampler takes (u, v) = (x, y)
        sampled = grid_sample_bilinear(corr, uv)  # (BHW, 1, K, 1)
        out.append(sampled.reshape(b, h, w, k).permute(0, 3, 1, 2))
    return torch.cat(out, dim=1)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Learned 8x convex upsampling: flow (B, 2, h, w), mask (B, 576, h, w)
    (channel 64k + 8u + v: neighbour k of the 3x3, child (u, v)) -> (B, 2,
    8h, 8w), child (u, v) of pixel (i, j) at (8i + u, 8j + v)."""
    b, _, h, w = flow.shape
    m = torch.softmax(mask.reshape(b, 9, 8, 8, h, w), dim=1)
    fp = F.pad(8.0 * flow, (1, 1, 1, 1))
    neigh = torch.stack([fp[:, :, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
                        dim=1)  # (B, 9, 2, h, w)
    up = torch.einsum("bkuvhw,bkchw->bchuwv", m, neigh)
    return up.reshape(b, 2, 8 * h, 8 * w)


@dataclasses.dataclass
class RaftConfig:
    iters: int = 20
    corr_levels: int = 4
    corr_radius: int = 4
    hidden_dim: int = 128
    context_dim: int = 128


class RAFT(nn.Module):
    """fnet, cnet and the update block; ``compute_flow`` gives the forward
    flow."""

    def __init__(self, config: RaftConfig = RaftConfig()):
        super().__init__()
        self.cfg = config
        corr_channels = config.corr_levels * (2 * config.corr_radius + 1) ** 2
        self.fnet = BasicEncoder(256)
        self.cnet = BasicEncoder(config.hidden_dim + config.context_dim)
        self.update = UpdateBlock(config.hidden_dim, config.context_dim, corr_channels)

    def compute_flow(self, img1: torch.Tensor, img2: torch.Tensor, iters: int | None = None,
                     all_iters: bool = False) -> torch.Tensor:
        """img1, img2 (B, 3, H, W) in [0, 1], H and W multiples of 8 (pad
        with ``motion_mask_driver.pad_to_multiple``) -> (B, 2, H, W) flow as
        (dx, dy); with ``all_iters`` the upsampled flow of every iteration,
        (T, B, 2, H, W)."""
        cfg = self.cfg
        iters = iters or cfg.iters
        x1 = 2.0 * img1 - 1.0
        x2 = 2.0 * img2 - 1.0
        f1, f2 = self.fnet(x1), self.fnet(x2)
        c = self.cnet(x1)
        net = torch.tanh(c[:, :cfg.hidden_dim])
        context = F.relu(c[:, cfg.hidden_dim:])
        pyramid = correlation_pyramid(f1, f2, cfg.corr_levels)
        b, _, h8, w8 = f1.shape
        gy, gx = torch.meshgrid(torch.arange(h8, dtype=torch.float32, device=f1.device),
                                torch.arange(w8, dtype=torch.float32, device=f1.device),
                                indexing="ij")
        coords0 = torch.stack([gy, gx])[None].expand(b, 2, h8, w8)  # (y, x)
        coords = coords0
        ups = []
        for it in range(iters):
            corr = lookup_corr(pyramid, coords, cfg.corr_radius)
            net, mask, df = self.update(net, context, corr, (coords - coords0).flip(1))
            coords = coords + df.flip(1)  # df is (dx, dy)
            if all_iters or it == iters - 1:
                ups.append(convex_upsample((coords - coords0).flip(1), mask))
        return torch.stack(ups) if all_iters else ups[-1]


def sequence_loss(flow_preds: torch.Tensor, flow_gt: torch.Tensor, valid: torch.Tensor,
                  gamma: float = 0.8, max_flow: float = 400.0):
    """RAFT's training loss: the L1 error of every iteration's upsampled
    flow, weighted gamma^(T - 1 - t), over the valid pixels (valid > 0.5 and
    a ground-truth flow shorter than ``max_flow``) of the step's global
    batch, and the last iteration's end-point error metrics ('epe', '1px',
    '3px', '5px'). flow_preds (T, B, 2, H, W) as
    ``compute_flow(all_iters=True)`` gives them, flow_gt (B, 2, H, W), valid
    (B, H, W) -> (loss, metrics), scalar tensors."""
    v = (valid > 0.5) & (torch.linalg.vector_norm(flow_gt, dim=1) < max_flow)
    vf = v.to(flow_preds.dtype)
    n = flow_preds.shape[0]
    weights = gamma ** torch.arange(n - 1, -1, -1, dtype=torch.float32,
                                    device=flow_preds.device)
    l1 = torch.sum(torch.abs(flow_preds - flow_gt[None]), dim=2)  # (T, B, H, W)
    epe = torch.where(v, torch.linalg.vector_norm(flow_preds[-1] - flow_gt, dim=1), 0.0)
    # one sum over the step's global batch (parallel.mesh.batch_sum): the
    # per-iteration errors, the valid count and the metrics' counts
    sums = batch_sum(torch.cat([
        torch.sum(l1 * vf[None], dim=(1, 2, 3)),
        torch.stack([vf.sum(), epe.sum().detach()]
                    + [((epe < px) & v).sum().to(vf.dtype) for px in (1, 3, 5)])]))
    denom = torch.clamp_min(sums[n], 1.0)
    loss = torch.sum(weights * sums[:n] / denom)
    metrics = {"epe": sums[n + 1] / denom}
    for i, px in enumerate((1, 3, 5)):
        metrics[f"{px}px"] = sums[n + 2 + i] / denom
    return loss, metrics
