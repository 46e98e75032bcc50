"""Quantified inpainting validation on the PyTorch port (the counterpart of
tools/validate_inpaint.py).

1. renders a clip of the synthetic street scene (exact ray-traced frames);
2. trains the InpaintGenerator self-supervised (random stroke masks over
   complete frames, L1 with 4x hole weight: process_data/inpaint.py);
3. evaluates the masked-region PSNR on held-out frames with fresh masks,
   against two baselines: the untrained generator and a constant-gray fill;
4. runs the sliding-window driver (process_data/inpaint.run) on the held-out
   clip and writes its fill_img/ composites.

The generator starts from seeded weights (networks.init_weights, seed 0);
the stroke masks come from torch.Generators (eval masks seeded 7777 + scene,
training masks seeded 2), so they are not the JAX tool's draws. Runs on
the CUDA card unless --platform cpu; without CUDA it raises. Writes
result.json with the JAX tool's keys under --out.

Usage: python tools/validate_inpaint_torch.py --steps 800 --size 128
"""

from __future__ import annotations

import sys
from pathlib import Path

# repo-root import shim: `python tools/x.py` puts tools/ (not the repo
# root) on sys.path, so nerf_kbs_tpu_torch would not resolve without this
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import argparse
import json
import time

import numpy as np
import torch

from nerf_kbs_tpu_torch.data.synthetic_kitti import FX, FY, make_poses, make_scene, render_frame
from nerf_kbs_tpu_torch.process_data.inpaint import (
    InpaintDriverConfig,
    make_inpaint_train_step,
    random_stroke_masks,
    run,
)
from nerf_kbs_tpu_torch.process_data.networks import init_weights
from nerf_kbs_tpu_torch.process_data.networks.inpaint_net import InpaintConfig, InpaintGenerator
from nerf_kbs_tpu_torch.utils.images import encode_png_u8
from study_field_torch import platform_device


def masked_psnr(pred, gt, mask):
    m = mask[..., None]
    mse = float((((pred - gt) ** 2) * m).sum() / max(m.sum() * 3, 1.0))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--size", type=int, default=128, help="square working size")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--window", type=int, default=6)
    ap.add_argument("--clips", type=int, default=1,
                    help="number of DIFFERENT scenes to train on (seeds 0..N-1)")
    ap.add_argument("--heldout-scenes", type=int, default=1,
                    help="number of never-seen eval scenes (with --heldout-scene); "
                    "scene seeds 1000..")
    ap.add_argument("--heldout-scene", action="store_true",
                    help="evaluate on a FRESH scene (seed 1000) instead of "
                         "held-out frames of the training scene")
    ap.add_argument("--out", default="outputs/inpaint_validation")
    ap.add_argument("--platform", default=None, help="cpu; the CUDA card if unset")
    args = ap.parse_args(argv)
    dev = platform_device(args.platform)

    h = w = args.size

    def render_clip(seed: int, n_frames: int) -> np.ndarray:
        boxes = make_scene(seed, n_frames * 0.8 + 90.0)
        poses = make_poses(n_frames, step=0.8)
        # the focals scaled to the working size, as every other caller does
        # (render_frame scales only cx and cy)
        fx, fy = FX * w / 1242.0, FY * h / 375.0
        return np.stack(
            [render_frame(p, boxes, h, w, fx, fy)[0] for p in poses]
        ).astype(np.float32)

    def on_device(clip: np.ndarray) -> torch.Tensor:
        """(T, H, W, 3) -> (T, 3, H, W) on the device."""
        return torch.as_tensor(clip, device=dev).permute(0, 3, 1, 2).contiguous()

    print(f"rendering {args.clips} clip(s) x {args.frames} frames at {h}x{w} ...",
          flush=True)
    clips = [render_clip(s, args.frames) for s in range(args.clips)]
    if args.heldout_scene:
        train_clips = [on_device(c) for c in clips]
        eval_clips = [on_device(render_clip(1000 + i, args.frames))
                      for i in range(args.heldout_scenes)]
    else:
        if args.frames < 2 * args.window:
            raise ValueError(
                f"--frames {args.frames} < 2x --window {args.window}: the "
                "split cannot hold a training window AND an eval window — "
                "use --heldout-scene or more frames"
            )
        # never below one full training window
        n_train = max(
            min(args.frames * 3 // 4, args.frames - args.window), args.window
        )
        train_clips = [on_device(clips[0][:n_train])]
        train_clips += [on_device(c) for c in clips[1:]]
        eval_clips = [on_device(clips[0][n_train:])]
    eval_clip = eval_clips[0]

    gen = init_weights(InpaintGenerator(InpaintConfig()), torch.Generator().manual_seed(0)).to(dev)
    T = args.window
    step_fn = make_inpaint_train_step(gen)

    # held-out eval windows and fresh masks, fixed across checkpoints
    eval_masks_list = [
        random_stroke_masks(torch.Generator(device=dev).manual_seed(7777 + i),
                            ec.shape[0], h, w)
        for i, ec in enumerate(eval_clips)
    ]
    eval_masks = eval_masks_list[0]

    @torch.no_grad()
    def clip_masked_psnr(ec, mks):
        outs = []
        for s in range(0, ec.shape[0] - T + 1, T):
            fr = ec[s : s + T]
            mk = mks[s : s + T]
            # the generator masks its input itself (frames * (1 - holes))
            pred = gen(fr[None], mk[None])[0]
            comp = pred * mk[:, None] + fr * (1.0 - mk[:, None])
            outs.append(masked_psnr(comp.permute(0, 2, 3, 1).cpu().numpy(),
                                    fr.permute(0, 2, 3, 1).cpu().numpy(), mk.cpu().numpy()))
        return float(np.mean(outs))

    def eval_masked_psnr(all_scenes: bool = False):
        if not all_scenes:
            return clip_masked_psnr(eval_clip, eval_masks)
        return [clip_masked_psnr(ec, mk) for ec, mk in zip(eval_clips, eval_masks_list)]

    def gray_psnr(ec, mks):
        outs = []
        for s in range(0, ec.shape[0] - T + 1, T):
            fr = ec[s : s + T].permute(0, 2, 3, 1).cpu().numpy()
            mk = mks[s : s + T].cpu().numpy()
            comp = np.where(mk[..., None] > 0, 0.5, fr)
            outs.append(masked_psnr(comp, fr, mk))
        return float(np.mean(outs))

    baseline_gray_scenes = [gray_psnr(ec, mk) for ec, mk in zip(eval_clips, eval_masks_list)]
    baseline_gray = baseline_gray_scenes[0]
    baseline_untrained = eval_masked_psnr()

    print(f"baseline gray-fill masked PSNR:   {baseline_gray:.2f}", flush=True)
    print(f"baseline untrained generator:     {baseline_untrained:.2f}", flush=True)

    t0 = time.time()
    rng_host = np.random.default_rng(0)
    mask_gen = torch.Generator(device=dev).manual_seed(2)
    for i in range(args.steps):
        clip_i = train_clips[int(rng_host.integers(0, len(train_clips)))]
        # inclusive upper start (shape[0] - T is a valid window)
        hi = int(clip_i.shape[0]) - T + 1
        if hi <= 0:
            raise ValueError(
                f"clip of {int(clip_i.shape[0])} frames is shorter than the "
                f"window {T}"
            )
        s = int(rng_host.integers(0, hi))
        fr = clip_i[s : s + T]
        mk = random_stroke_masks(mask_gen, T, h, w)
        loss = step_fn(fr[None], mk[None])
        if (i + 1) % 100 == 0:
            print(
                f"step {i+1}: loss={float(loss):.4f} "
                f"eval_masked_psnr={eval_masked_psnr():.2f} "
                f"({time.time()-t0:.0f}s)",
                flush=True,
            )

    final_scenes = eval_masked_psnr(all_scenes=True)
    final = final_scenes[0]
    result = {
        "masked_psnr_trained": final,
        "masked_psnr_untrained": baseline_untrained,
        "masked_psnr_gray_fill": baseline_gray,
        "steps": args.steps,
        "frames": args.frames,
        "size": args.size,
        "clips": args.clips,
        "heldout_scene": bool(args.heldout_scene),
        # per-scene masked PSNR on the unseen scenes; scene[0] is the
        # fixed-protocol number
        "heldout_scenes": int(args.heldout_scenes),
        "masked_psnr_trained_per_scene": [round(v, 3) for v in final_scenes],
        "masked_psnr_trained_mean": round(float(np.mean(final_scenes)), 3),
        "masked_psnr_gray_fill_per_scene": [round(v, 3) for v in baseline_gray_scenes],
    }

    # frames and masks to disk, then the sliding-window inpainting run
    out = Path(args.out)
    (out / "images").mkdir(parents=True, exist_ok=True)
    (out / "masks").mkdir(exist_ok=True)
    frames = eval_clip.permute(0, 2, 3, 1).cpu().numpy()
    masks = eval_masks.cpu().numpy()
    for i in range(frames.shape[0]):
        (out / "images" / f"{i:05d}.png").write_bytes(
            encode_png_u8((frames[i] * 255).astype(np.uint8)))
        (out / "masks" / f"{i:05d}.png").write_bytes(
            encode_png_u8((masks[i] * 255).astype(np.uint8)))
    written = run(
        InpaintDriverConfig(
            image_dir=str(out / "images"),
            mask_dir=str(out / "masks"),
            output_dir=str(out / "fill_img"),
            width=w,
            height=h,
            window=T,
            dilate_iters=0,
        ),
        generator=gen,
        device=dev,
    )
    result["fill_img_count"] = len(written)
    print(json.dumps(result), flush=True)
    (out / "result.json").write_text(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
