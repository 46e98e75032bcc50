"""The instance segmenter of the motion-mask pipeline (the JAX package's
``process_data/networks/segmenter.py``): a U-Net over rgb, moving
probability and optical flow (6 channels) -> a foreground logit and each
pixel's offset to its instance's centroid; centroid votes are clustered on a
coarse grid into instance labels (``extract_instances``, NumPy).

Training: ``make_targets`` and ``boundary_weight`` (NumPy) give the targets
of an instance map, ``segmenter_loss`` the loss, ``make_segmenter_train_step``
an Adam step. ``load_segmenter`` / ``save_segmenter`` read and write the JAX
package's ``.npz`` checkpoints (``outputs/segmenter{2,3}/segmenter.npz``,
flax ``keystr`` keys such as ``['params']['down_0']['c0']['kernel']``) with
NumPy alone: either package reads the other's files."""

from __future__ import annotations

import dataclasses
import re
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nerf_kbs_tpu_torch.device import resolve_device
from nerf_kbs_tpu_torch.process_data import networks


@dataclasses.dataclass(frozen=True)
class SegmenterConfig:
    in_channels: int = 6
    widths: Sequence[int] = (32, 64, 128)
    # offsets are regressed in units of offset_scale pixels
    offset_scale: float = 64.0


class ConvBlock(nn.Module):
    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.c0 = nn.Conv2d(in_ch, features, 3, 1, 1)
        self.c1 = nn.Conv2d(features, features, 3, 1, 1)

    def forward(self, x):
        return F.relu(self.c1(F.relu(self.c0(x))))


class InstanceSegmenter(nn.Module):
    """(B, 6, H, W) -> (B, 3, H, W): [fg_logit, off_y, off_x], the offsets in
    offset_scale units."""

    def __init__(self, cfg: SegmenterConfig = SegmenterConfig()):
        super().__init__()
        self.cfg = cfg
        widths = list(cfg.widths)
        in_ch = cfg.in_channels
        for i, w in enumerate(widths):
            self.add_module(f"down_{i}", ConvBlock(in_ch, w))
            in_ch = w
        for i in range(len(widths) - 2, -1, -1):
            self.add_module(f"up_{i}", ConvBlock(in_ch + widths[i], widths[i]))
            in_ch = widths[i]
        self.head = nn.Conv2d(in_ch, 3, 1)

    def forward(self, x):
        n = len(self.cfg.widths)
        skips = []
        for i in range(n):
            x = getattr(self, f"down_{i}")(x)
            skips.append(x)
            if i < n - 1:
                x = F.max_pool2d(x, 2, 2)
        for i in range(n - 2, -1, -1):
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            skip = skips[i]
            # an odd skip shrank through the pool (floor): pad up with the
            # edge, never crop
            x = networks.pad_edge(networks.pad_edge(x, 3, skip.shape[3] - x.shape[3]), 2,
                                  skip.shape[2] - x.shape[2])
            x = getattr(self, f"up_{i}")(torch.cat([x, skip], dim=1))
        return self.head(x)


def make_inputs(rgb: np.ndarray, moving_prob: np.ndarray, optical_flow: np.ndarray) -> np.ndarray:
    """The (H, W, 6) input: rgb (H, W, 3) in [0, 1], moving_prob (H, W) and
    optical_flow (2, H, W) in pixels, divided by its largest component."""
    f = np.asarray(optical_flow, np.float32)
    f = f / max(float(np.abs(f).max()), 1e-6)
    return np.concatenate([np.asarray(rgb, np.float32),
                           np.asarray(moving_prob, np.float32)[..., None],
                           f.transpose(1, 2, 0)], axis=-1)


@torch.no_grad()
def predict(model: InstanceSegmenter, x: np.ndarray):
    """x (H, W, 6) -> (fg_prob (H, W), offsets in pixels (H, W, 2)), on the
    model's device, returned as NumPy."""
    dev = next(model.parameters()).device
    inp = torch.as_tensor(np.asarray(x, np.float32), device=dev).permute(2, 0, 1)[None]
    out = model(inp)[0].permute(1, 2, 0).cpu().numpy()
    z = out[..., 0]
    # overflow-stable sigmoid
    fg = np.where(z >= 0, 1.0 / (1.0 + np.exp(-np.abs(z))),
                  np.exp(-np.abs(z)) / (1.0 + np.exp(-np.abs(z))))
    return fg, out[..., 1:] * model.cfg.offset_scale


def extract_instances(fg_prob: np.ndarray, offsets: np.ndarray, fg_threshold: float = 0.5,
                      cell: int = 12, min_votes: int = 40, assign_radius: float = 48.0,
                      min_area: int = 64) -> np.ndarray:
    """Cluster centroid votes into an instance-label map (0 = background).

    Foreground pixels vote (y + oy, x + ox); the votes histogram onto a grid
    of ``cell``-pixel cells; the best-voted cell (3x3-smoothed) that holds
    votes becomes a centre (the mean of the votes in its 3x3 block) and its
    block is suppressed, until no cell reaches ``min_votes``; centres closer
    than a cell merge; pixels go to the nearest centre within
    ``assign_radius``; instances under ``min_area`` are dropped."""
    h, w = fg_prob.shape
    fg = fg_prob > fg_threshold
    if not fg.any():
        return np.zeros((h, w), np.int32)
    ys, xs = np.nonzero(fg)
    vy = np.clip(ys + offsets[ys, xs, 0], 0, h - 1)
    vx = np.clip(xs + offsets[ys, xs, 1], 0, w - 1)
    gh, gw = h // cell + 1, w // cell + 1
    cy = (vy / cell).astype(np.int32)
    cx = (vx / cell).astype(np.int32)
    hist = np.zeros((gh, gw), np.int64)
    np.add.at(hist, (cy, cx), 1)
    pad = np.pad(hist, 1)
    smooth = sum(pad[1 + dy:1 + dy + gh, 1 + dx:1 + dx + gw]
                 for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    score = np.where(hist > 0, smooth, 0)
    centers = []
    for _ in range(int(score.size)):
        gy, gx = np.unravel_index(int(np.argmax(score)), score.shape)
        if score[gy, gx] < min_votes:
            break
        m = (np.abs(cy - gy) <= 1) & (np.abs(cx - gx) <= 1)
        if m.any():
            centers.append((vy[m].mean(), vx[m].mean()))
        score[max(gy - 1, 0):min(gy + 2, gh), max(gx - 1, 0):min(gx + 2, gw)] = 0
    if not centers:
        return np.zeros((h, w), np.int32)
    keep = []
    for c in np.array(centers):
        if all(np.hypot(*(c - k)) > cell for k in keep):
            keep.append(c)
    centers = np.array(keep)
    d = np.hypot(vy[:, None] - centers[None, :, 0], vx[:, None] - centers[None, :, 1])
    nearest = np.argmin(d, axis=1)
    ok = d[np.arange(len(vy)), nearest] <= assign_radius
    lbl = np.zeros((h, w), np.int32)
    lbl[ys[ok], xs[ok]] = nearest[ok] + 1
    out = np.zeros_like(lbl)
    nxt = 1
    for n in range(1, len(centers) + 1):
        m = lbl == n
        if m.sum() >= min_area:
            out[m] = nxt
            nxt += 1
    return out


def make_targets(instance_labels: np.ndarray, offset_scale: float = 64.0):
    """(fg (H, W), offsets (H, W, 2), valid (H, W)) float32 from an int
    instance map (0 = background): each instance pixel's offset to its
    instance's centroid, (dy, dx) in units of ``offset_scale`` pixels."""
    lbl = np.asarray(instance_labels)
    h, w = lbl.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    fg = (lbl > 0).astype(np.float32)
    off = np.zeros((h, w, 2), np.float32)
    for n in np.unique(lbl):
        if n <= 0:
            continue
        m = lbl == n
        cy, cx = ys[m].mean(), xs[m].mean()
        off[m, 0] = (cy - ys[m]) / offset_scale
        off[m, 1] = (cx - xs[m]) / offset_scale
    return fg, off, fg.copy()


def boundary_weight(instance_labels: np.ndarray, radius: int = 2, gain: float = 4.0) -> np.ndarray:
    """Per-pixel loss weight: 1 + ``gain`` within ``radius`` pixels (4-
    neighbour steps) of a label change (object and background, or two
    touching objects, where the centroid votes split), else 1."""
    lbl = np.asarray(instance_labels)
    b = np.zeros(lbl.shape, bool)
    b[:-1] |= lbl[:-1] != lbl[1:]
    b[1:] |= lbl[1:] != lbl[:-1]
    b[:, :-1] |= lbl[:, :-1] != lbl[:, 1:]
    b[:, 1:] |= lbl[:, 1:] != lbl[:, :-1]
    for _ in range(radius):
        d = b.copy()
        d[:-1] |= b[1:]
        d[1:] |= b[:-1]
        d[:, :-1] |= b[:, 1:]
        d[:, 1:] |= b[:, :-1]
        b = d
    return (1.0 + gain * b).astype(np.float32)


def segmenter_loss(model: InstanceSegmenter, batch: dict):
    """batch: x (B, 6, H, W), fg (B, H, W), off (B, 2, H, W), valid (B, H,
    W), and optionally the per-pixel weight w (B, H, W) of
    ``boundary_weight``. -> (loss, {"bce", "offset_l1", "fg_acc"}): the
    (weighted) logistic loss of the foreground logit plus the (weighted) L1
    of the offsets over the valid pixels."""
    out = model(batch["x"])
    logit, off = out[:, 0], out[:, 1:]
    fg = batch["fg"]
    w = batch.get("w")
    bce_px = torch.clamp_min(logit, 0.0) - logit * fg + torch.log1p(torch.exp(-logit.abs()))
    bce = bce_px.mean() if w is None else torch.sum(w * bce_px) / torch.clamp_min(w.sum(), 1.0)
    v = batch["valid"][:, None]
    if w is not None:
        v = v * w[:, None]
    l1 = torch.sum(v * torch.abs(off - batch["off"])) / torch.clamp_min(v.sum(), 1.0)
    acc = torch.mean(((logit > 0) == (fg > 0.5)).to(torch.float32))
    return bce + l1, {"bce": bce, "offset_l1": l1, "fg_acc": acc}


def make_segmenter_train_step(model: InstanceSegmenter, lr: float = 3e-4):
    """step(batch) -> (loss, metrics): one Adam update (optax's defaults)
    of ``segmenter_loss``, ``model`` changed in place, its convolutions on
    cuDNN's deterministic algorithms."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def step(batch: dict):
        with networks.deterministic_convolutions():
            loss, metrics = segmenter_loss(model, batch)
            opt.zero_grad()
            loss.backward()
        opt.step()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    return step


def save_segmenter(path: str, model: InstanceSegmenter) -> None:
    """The weights as a JAX-package ``.npz``: flax ``keystr`` keys
    (``['params']['down_0']['c0']['kernel']``), kernels HWIO."""
    arrs = {}
    for name, t in model.state_dict().items():
        *mods, leaf = name.split(".")
        v = t.detach().cpu().numpy()
        if leaf == "weight":
            leaf, v = "kernel", v.transpose(2, 3, 1, 0)
        arrs["['params']" + "".join(f"['{m}']" for m in mods) + f"['{leaf}']"] = v
    np.savez(path, **arrs)


def load_segmenter(path: str, cfg: SegmenterConfig = SegmenterConfig(),
                   device=None) -> InstanceSegmenter:
    """An ``InstanceSegmenter`` on ``device`` (CUDA unless "cpu") with the
    weights of a JAX ``.npz`` checkpoint."""
    from nerf_kbs_tpu_torch.process_data.convert import segmenter_from_jax

    with np.load(path) as data:
        tree: dict = {}
        for key in data.files:
            node = tree
            *parents, leaf = re.findall(r"\['([^']+)'\]", key)
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    model = InstanceSegmenter(cfg)
    model.load_state_dict(segmenter_from_jax(tree))
    return model.to(resolve_device(device)).eval()
