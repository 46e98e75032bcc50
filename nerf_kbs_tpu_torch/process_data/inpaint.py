"""The video-inpainting driver: sliding-window completion of the masked
(dynamic) regions of a frame sequence (the JAX package's
``process_data/inpaint.py``), and its self-supervised trainer
(``make_inpaint_train_step``, ``random_stroke_masks``).

- masks are read with PIL's NEAREST rule, then dilated with a 10x10 cross 4
  times (OpenCV's pixels); frames with PIL's BICUBIC, at 432 x 240;
- windows of ``window`` frames centred every ``neighbor_stride`` frames (the
  stride clamped to the window) plus one anchored at the tail, so every
  frame is visited; a short clip is mirror-padded;
- each window's prediction is composited as pred * mask + frame * (1 -
  mask); a frame visited again is blended 0.5 / 0.5 with its last value;
- H and W are edge-padded to multiples of 4 and cropped back;
- fill_img/rgb_%05d.jpg is written at quality 95 (``utils.jpeg``).

The generator runs on the CUDA card unless ``device="cpu"``; without given
weights it is seeded (``networks.init_weights``)."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from nerf_kbs_tpu_torch.device import resolve_device
from nerf_kbs_tpu_torch.process_data import networks
from nerf_kbs_tpu_torch.process_data.motion_mask import dilate_mask
from nerf_kbs_tpu_torch.process_data.motion_mask_driver import list_frames, load_frame
from nerf_kbs_tpu_torch.utils.images import read_image, resize_nearest
from nerf_kbs_tpu_torch.utils.jpeg import encode_jpeg


@dataclasses.dataclass
class InpaintDriverConfig:
    image_dir: str = "images"
    mask_dir: str = "masks"
    output_dir: str = "fill_img"
    width: int = 432
    height: int = 240
    neighbor_stride: int = 4
    window: int = 10  # frames fed to the generator at once
    dilate_size: int = 10
    dilate_iters: int = 4
    seed: int = 0


def load_frames_and_masks(cfg: InpaintDriverConfig):
    """-> (frames (T, H, W, 3) float32, dilated masks (T, H, W) float32,
    names). Frames and masks pair by file stem; a frame without a mask
    raises."""
    frame_paths = list_frames(cfg.image_dir)
    mask_paths = list_frames(cfg.mask_dir)
    if not frame_paths or not mask_paths:
        raise ValueError(f"no frames/masks under {cfg.image_dir} / {cfg.mask_dir}")
    by_stem = {p.stem: p for p in mask_paths}
    pairs = [(fp, by_stem[fp.stem]) for fp in frame_paths if fp.stem in by_stem]
    if not pairs:
        raise ValueError(f"no frame/mask stem matches between {cfg.image_dir} and {cfg.mask_dir}")
    missing = [fp.name for fp in frame_paths if fp.stem not in by_stem]
    if missing:
        raise ValueError(f"masks missing for {len(missing)} frame(s), e.g. {missing[:3]} — "
                         f"every frame needs a same-stem mask in {cfg.mask_dir}")
    frames, masks = [], []
    for fp, mp in pairs:
        frames.append(load_frame(fp, cfg.width, cfg.height))
        m = resize_nearest(read_image(mp, "L"), cfg.width, cfg.height) > 0
        masks.append(dilate_mask(m.astype(np.uint8), cfg.dilate_size, cfg.dilate_iters))
    return np.stack(frames), np.stack(masks).astype(np.float32), [fp.name for fp, _ in pairs]


def seeded_generator(seed: int = 0):
    from nerf_kbs_tpu_torch.process_data.networks import init_weights
    from nerf_kbs_tpu_torch.process_data.networks.inpaint_net import InpaintGenerator

    return init_weights(InpaintGenerator(), torch.Generator().manual_seed(seed))


def window_plan(t: int, neighbor_stride: int, window: int) -> list[list[int]]:
    """The frame ids fed to each window, in order. A clip shorter than the
    window is padded with its own mirror, so its distinct ids, first to
    last, are the real frames."""
    step = min(max(neighbor_stride, 1), max(window, 1))
    plan = []
    for center in dict.fromkeys(list(range(0, t, step)) + [max(0, t - 1)]):
        lo = max(0, center - window // 2)
        hi = min(t, lo + window)
        lo = max(0, hi - window)
        ids = list(range(lo, hi))
        plan.append((ids + ids[::-1])[:window] if len(ids) < window else ids)
    return plan


@torch.no_grad()
def inpaint_video(frames: np.ndarray, masks: np.ndarray, generator=None, neighbor_stride: int = 4,
                  window: int = 10, seed: int = 0, device=None) -> np.ndarray:
    """frames (T, H, W, 3) float32 in [0, 1], masks (T, H, W) float32 (1 =
    hole) -> completed frames, clipped to [0, 1]."""
    dev = resolve_device(device)
    t = frames.shape[0]
    h0, w0 = frames.shape[1:3]
    ph, pw = (-h0) % 4, (-w0) % 4
    if ph or pw:
        frames = np.pad(frames, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="edge")
        masks = np.pad(masks, ((0, 0), (0, ph), (0, pw)), mode="edge")
    if generator is None:
        generator = seeded_generator(seed)
    generator = generator.to(dev).eval()

    out = frames.copy()
    visited = np.zeros(t, bool)
    for ids in window_plan(t, neighbor_stride, window):
        clip = torch.as_tensor(out[ids], device=dev).permute(0, 3, 1, 2)[None]
        mclip = torch.as_tensor(masks[ids], device=dev)[None]
        pred = generator(clip, mclip)[0].permute(0, 2, 3, 1).cpu().numpy()
        for k, fi in enumerate(dict.fromkeys(ids)):
            m = masks[fi][..., None]
            comp = pred[k] * m + frames[fi] * (1.0 - m)
            if visited[fi]:
                out[fi] = 0.5 * out[fi] + 0.5 * comp
            else:
                out[fi] = comp
                visited[fi] = True
    return np.clip(out[:, :h0, :w0], 0.0, 1.0)


def run(cfg: InpaintDriverConfig, generator=None, device=None) -> list[str]:
    """Load, inpaint, write fill_img/rgb_%05d.jpg -> the written paths.
    ``generator`` is an ``InpaintGenerator`` with trained weights; None
    seeds one (plumbing only)."""
    frames, masks, _names = load_frames_and_masks(cfg)
    out = inpaint_video(frames, masks, generator=generator, neighbor_stride=cfg.neighbor_stride,
                        window=cfg.window, seed=cfg.seed, device=device)
    outdir = Path(cfg.output_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    written = []
    for i, img in enumerate(out):
        p = outdir / f"rgb_{i:05d}.jpg"
        p.write_bytes(encode_jpeg((img * 255).astype(np.uint8), quality=95))
        written.append(str(p))
    return written


# ---------------------------------------------------------------------------
# self-supervised training
# ---------------------------------------------------------------------------


def make_inpaint_train_step(generator, lr: float = 1e-4):
    """The generator's self-supervised trainer: random holes over complete
    clips, the L1 reconstruction error weighted 4x inside the hole, Adam
    (optax's defaults: b1 0.9, b2 0.999, eps 1e-8). Returns step(frames,
    masks) -> loss, one update of ``generator`` in place; frames (B, T, 3,
    H, W) in [0, 1], masks (B, T, H, W) (1 = hole), on its device; the
    convolutions on cuDNN's deterministic algorithms."""
    opt = torch.optim.Adam([p for p in generator.parameters() if p.requires_grad], lr=lr,
                           betas=(0.9, 0.999), eps=1e-8)

    def step(frames: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        with networks.deterministic_convolutions():
            pred = generator(frames, masks)
            loss = torch.mean(torch.abs(pred - frames) * (1.0 + 3.0 * masks[:, :, None]))
            opt.zero_grad()
            loss.backward()
        opt.step()
        return loss.detach()

    return step


def random_stroke_masks(generator: torch.Generator, t: int, h: int, w: int,
                        num_rects: int = 3) -> torch.Tensor:
    """(t, h, w) float32 hole masks on the generator's device: the union of
    ``num_rects`` rectangles a frame, corners in [0, h - 8) x [0, w - 8),
    heights in [4, h // 3), widths in [4, w // 3) (the ranges of the JAX
    package's PRNG draws, whose values differ)."""
    dev = generator.device
    ys, xs, hs, ws = (torch.randint(lo, hi, (t, num_rects), generator=generator, device=dev)
                      for lo, hi in ((0, max(h - 8, 1)), (0, max(w - 8, 1)),
                                     (4, max(h // 3, 5)), (4, max(w // 3, 5))))
    yy = torch.arange(h, device=dev)[None, :, None, None]
    xx = torch.arange(w, device=dev)[None, None, :, None]
    inside = ((yy >= ys[:, None, None]) & (yy < (ys + hs)[:, None, None])
              & (xx >= xs[:, None, None]) & (xx < (xs + ws)[:, None, None]))
    return inside.any(dim=-1).to(torch.float32)
