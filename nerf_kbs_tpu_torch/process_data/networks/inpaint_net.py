"""The video-inpainting generator (the JAX package's
``process_data/networks/inpaint_net.py``): a frame encoder to 1/4
resolution, bidirectional flow-guided propagation, spatio-temporal window
attention and a convolutional decoder.

Three flax defaults are kept: LayerNorm's epsilon 1e-6, the tanh GELU, and
attention with a bias on each of q, k, v and the output (the per-head
kernels (C, heads, head_dim) and (heads, head_dim, C) become (C, C)
matrices, heads major). The attention is the explicit product
softmax(q k^T / sqrt(head_dim)) v that flax computes, and the decoder's x2
bilinear upsampling a fixed stencil, and the attention window's edge
padding a concatenation (``networks.pad_edge``): the backward of each sums in
one order (no atomic adds), so a training step repeats bit for bit."""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from nerf_kbs_tpu_torch.process_data.networks import pad_edge
from nerf_kbs_tpu_torch.process_data.warp import flow_warp


@dataclasses.dataclass(frozen=True)
class InpaintConfig:
    channels: int = 64
    num_attention_blocks: int = 4
    num_heads: int = 4
    window: int = 8  # spatial attention window at 1/4 resolution


class FrameEncoder(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.down1 = nn.Conv2d(4, ch // 2, 3, 2, 1)
        self.conv1 = nn.Conv2d(ch // 2, ch // 2, 3, 1, 1)
        self.down2 = nn.Conv2d(ch // 2, ch, 3, 2, 1)
        self.conv2 = nn.Conv2d(ch, ch, 3, 1, 1)

    def forward(self, x):
        # (B*T, 4, H, W): rgb and the hole mask -> 1/4 resolution
        for conv in (self.down1, self.conv1, self.down2, self.conv2):
            x = F.relu(conv(x))
        return x


class FlowEstimator(nn.Module):
    """Flow (dx, dy) between two 1/4-resolution features."""

    def __init__(self, ch: int):
        super().__init__()
        self.c1 = nn.Conv2d(2 * ch, 64, 3, 1, 1)
        self.c2 = nn.Conv2d(64, 64, 3, 1, 1)
        self.c3 = nn.Conv2d(64, 32, 3, 1, 1)
        self.out = nn.Conv2d(32, 2, 3, 1, 1)

    def forward(self, fa, fb):
        y = torch.cat([fa, fb], dim=1)
        for conv in (self.c1, self.c2, self.c3):
            y = F.relu(conv(y))
        return self.out(y)


class PropagationCell(nn.Module):
    """Gate a flow-warped neighbour's feature into the current frame's."""

    def __init__(self, ch: int):
        super().__init__()
        self.gate = nn.Conv2d(2 * ch, ch, 3, 1, 1)
        self.update = nn.Conv2d(2 * ch, ch, 3, 1, 1)

    def forward(self, cur, warped):
        x = torch.cat([cur, warped], dim=1)
        g = torch.sigmoid(self.gate(x))
        return cur * (1 - g) + F.relu(self.update(x)) * g


class MultiHeadAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` as self-attention: q, k, v and
    the output projection with biases, softmax(q k^T / sqrt(head_dim)) v."""

    def __init__(self, ch: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(ch, ch)
        self.key = nn.Linear(ch, ch)
        self.value = nn.Linear(ch, ch)
        self.out = nn.Linear(ch, ch)

    def forward(self, x):
        n, l, c = x.shape
        d = c // self.heads

        def split(t):
            return t.reshape(n, l, self.heads, d).transpose(1, 2)

        # flax scales the query, then takes the product and its softmax in f32
        q = split(self.query(x)) / math.sqrt(d)
        w = torch.softmax(q @ split(self.key(x)).transpose(-2, -1), dim=-1)
        y = w @ split(self.value(x))
        return self.out(y.transpose(1, 2).reshape(n, l, c))


class WindowAttentionBlock(nn.Module):
    """Self-attention over (T x window x window) token groups, then an MLP;
    both residual."""

    def __init__(self, ch: int, heads: int, window: int):
        super().__init__()
        self.window = window
        self.ln1 = nn.LayerNorm(ch, eps=1e-6)
        self.attn = MultiHeadAttention(ch, heads)
        self.ln2 = nn.LayerNorm(ch, eps=1e-6)
        self.mlp1 = nn.Linear(ch, 4 * ch)
        self.mlp2 = nn.Linear(4 * ch, ch)

    def forward(self, x):
        # x: (B, T, H, W, C), H and W divisible by the window
        b, t, h, w, c = x.shape
        win = self.window
        y = self.ln1(x).reshape(b, t, h // win, win, w // win, win, c)
        y = y.permute(0, 2, 4, 1, 3, 5, 6).reshape(b * (h // win) * (w // win), t * win * win, c)
        y = self.attn(y).reshape(b, h // win, w // win, t, win, win, c)
        x = x + y.permute(0, 3, 1, 4, 2, 5, 6).reshape(b, t, h, w, c)
        z = self.mlp2(F.gelu(self.mlp1(self.ln2(x)), approximate="tanh"))
        return x + z


def upsample2_bilinear(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, 2H, 2W), what ``jax.image.resize(...,
    "bilinear")`` gives at twice the size (half-pixel centres; an edge
    sample's weight outside the image falls to its neighbour): along each
    axis output 2i is 0.75 x[i] + 0.25 x[i - 1] and output 2i + 1 is
    0.75 x[i] + 0.25 x[i + 1], the neighbour replicated at the edges. Slices
    and weighted sums, whose backward adds in a fixed order (the backward of
    ``F.interpolate`` adds with atomics on the card)."""
    def along(t, dim):
        n = t.shape[dim]
        prev = torch.cat([t.narrow(dim, 0, 1), t.narrow(dim, 0, n - 1)], dim)
        nxt = torch.cat([t.narrow(dim, 1, n - 1), t.narrow(dim, n - 1, 1)], dim)
        pair = torch.stack([0.75 * t + 0.25 * prev, 0.75 * t + 0.25 * nxt], dim + 1)
        return pair.flatten(dim, dim + 1)

    return along(along(x, 2), 3)


class Decoder(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(ch, ch, 3, 1, 1)
        self.conv2 = nn.Conv2d(ch, ch // 2, 3, 1, 1)
        self.conv3 = nn.Conv2d(ch // 2, ch // 4, 3, 1, 1)
        self.out = nn.Conv2d(ch // 4, 3, 3, 1, 1)

    def forward(self, x):
        y = upsample2_bilinear(F.relu(self.conv1(x)))
        y = upsample2_bilinear(F.relu(self.conv2(y)))
        y = F.relu(self.conv3(y))
        return torch.tanh(self.out(y)) * 0.5 + 0.5


class InpaintGenerator(nn.Module):
    """frames (B, T, 3, H, W) in [0, 1], masks (B, T, H, W) (1 = hole), H
    and W multiples of 4 -> completed frames (B, T, 3, H, W)."""

    def __init__(self, cfg: InpaintConfig = InpaintConfig()):
        super().__init__()
        self.cfg = cfg
        ch = cfg.channels
        self.encoder = FrameEncoder(ch)
        self.flow = FlowEstimator(ch)
        self.prop_fwd = PropagationCell(ch)
        self.prop_bwd = PropagationCell(ch)
        for i in range(cfg.num_attention_blocks):
            self.add_module(f"block_{i}", WindowAttentionBlock(ch, cfg.num_heads, cfg.window))
        self.decoder = Decoder(ch)

    def _propagate(self, feats: list, cell: PropagationCell, reverse: bool) -> list:
        out = list(feats)
        prev = None
        for i in (range(len(feats) - 1, -1, -1) if reverse else range(len(feats))):
            cur = feats[i]
            if prev is not None:
                cur = cell(cur, flow_warp(prev, self.flow(cur, prev)))
            out[i] = prev = cur
        return out

    def forward(self, frames, masks):
        b, t, _, h, w = frames.shape
        ch = self.cfg.channels
        holes = masks[:, :, None]
        inp = torch.cat([frames * (1 - holes), holes], dim=2).reshape(b * t, 4, h, w)
        feats = self.encoder(inp).reshape(b, t, ch, h // 4, w // 4)
        seq = self._propagate([feats[:, i] for i in range(t)], self.prop_fwd, reverse=False)
        seq = self._propagate(seq, self.prop_bwd, reverse=True)
        x = torch.stack(seq, dim=1).permute(0, 1, 3, 4, 2)  # (B, T, h, w, C)
        # pad to the window with the edge: zero tokens would take part,
        # unmasked, in every border window's softmax
        win = self.cfg.window
        hq, wq = x.shape[2], x.shape[3]
        hp, wp = (-hq) % win, (-wq) % win
        x = pad_edge(pad_edge(x, 3, wp), 2, hp)
        for i in range(self.cfg.num_attention_blocks):
            x = getattr(self, f"block_{i}")(x)
        x = x[:, :, :hq, :wq].permute(0, 1, 4, 2, 3).reshape(b * t, ch, hq, wq)
        return self.decoder(x).reshape(b, t, 3, h, w)
