"""Decoder study on the PyTorch port (the counterpart of
tools/tune_decoder.py): tune extract_instances' hyperparameters offline on a
trained segmenter checkpoint.

Protocol (no eval-set selection bias): the hyperparameters are swept on a
tune set of touching-mover scenes (seeds 2000..) that overlaps neither the
training seeds (0..95) nor the fixed eval set (seeds 1000..); the winning
configuration is then scored once on the eval set. Two winners: the best
instance quality, and the best instance quality that holds the fused-mask
IoU within 0.005 of the baseline decoder's (the fused dynamic mask is what
the motion pipeline consumes).

The network runs on the CUDA card unless --platform cpu (the decoder and
the metrics are host NumPy); without CUDA it raises. The JAX tool has no
--platform: it always runs on the CPU.

Usage: python tools/tune_decoder_torch.py --ckpt outputs/segmenter3/segmenter.npz
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import argparse
import itertools
import json

import numpy as np

from nerf_kbs_tpu_torch.process_data.networks.segmenter import (
    extract_instances, load_segmenter, predict,
)
from study_field_torch import platform_device
from train_segmenter_torch import fused_mask, instance_quality, make_samples, mask_iou


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="outputs/segmenter3/segmenter.npz")
    ap.add_argument("--tune-scenes", type=int, default=6)
    ap.add_argument("--eval-scenes", type=int, default=8)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--h", type=int, default=96)
    ap.add_argument("--w", type=int, default=320)
    ap.add_argument("--out", default="outputs/segmenter_decoder")
    ap.add_argument("--platform", default=None, help="cpu; the CUDA card if unset")
    args = ap.parse_args(argv)
    dev = platform_device(args.platform)

    model = load_segmenter(args.ckpt, device=dev)

    def frames_for(seed0: int, n: int):
        out = []
        for s in range(n):
            out += make_samples(seed0 + s, args.frames, args.h, args.w,
                                touching=True)
        return out

    def predictions(frames):
        preds = []
        for x, _fg, _off, _v, inst_gt in frames:
            fg, off = predict(model, x)
            preds.append((fg, off, x[..., 3], inst_gt))
        return preds

    def score(preds, **kw):
        inst_q, fused = [], []
        for fg, off, prob, inst_gt in preds:
            inst = extract_instances(fg, off, **kw)
            inst_q.append(instance_quality(inst, inst_gt))
            hard = (prob > 0.3).astype(np.uint8)
            gt_mask = (inst_gt > 0).astype(np.uint8)
            fused.append(mask_iou(fused_mask(inst, hard), gt_mask))
        return float(np.mean(inst_q)), float(np.mean(fused))

    print("rendering tune scenes + running the net...", flush=True)
    tune = predictions(frames_for(2000, args.tune_scenes))

    base_kw = dict(fg_threshold=0.5, cell=12, min_votes=40,
                   assign_radius=48.0, min_area=64)
    base_q, base_f = score(tune, **base_kw)
    print(f"tune baseline: inst_q={base_q:.4f} fused={base_f:.4f}", flush=True)

    grid = {
        "cell": [4, 6, 8, 12],
        "min_votes": [15, 25, 40],
        "assign_radius": [32.0, 48.0, 64.0],
        "min_area": [32, 64],
    }
    results = []
    for vals in itertools.product(*grid.values()):
        kw = dict(base_kw)
        kw.update(dict(zip(grid.keys(), vals)))
        q, f = score(tune, **kw)
        results.append((q, f, kw))
    for q, f, kw in sorted(results, key=lambda r: -r[0])[:20]:
        print(f"  tune {q:.4f}/{f:.4f}  {kw}", flush=True)
    best = max(results, key=lambda r: (r[0], r[1]))
    cons = [r for r in results if r[1] >= base_f - 0.005]
    best_c = max(cons, key=lambda r: (r[0], r[1])) if cons else best
    best_kw, best_ckw = best[2], best_c[2]
    print(f"tune unconstrained best: {best[2]} -> {best[0]:.4f}/{best[1]:.4f}",
          flush=True)
    print(f"tune coverage-constrained best: {best_c[2]} -> "
          f"{best_c[0]:.4f}/{best_c[1]:.4f}", flush=True)

    print(f"scoring once on the fixed {args.eval_scenes}-scene eval set...", flush=True)
    evalp = predictions(frames_for(1000, args.eval_scenes))
    eval_base = score(evalp, **base_kw)
    eval_best = score(evalp, **best_kw)
    eval_best_c = score(evalp, **best_ckw)

    result = {
        "ckpt": args.ckpt,
        "tune_seeds": [2000 + i for i in range(args.tune_scenes)],
        "baseline_kw": base_kw,
        "tuned_kw": best_kw,
        "tuned_constrained_kw": best_ckw,
        "tune_baseline": {"instance_quality": base_q, "fused_iou": base_f},
        "tune_best": {"instance_quality": best[0], "fused_iou": best[1]},
        "tune_best_constrained": {"instance_quality": best_c[0],
                                  "fused_iou": best_c[1]},
        "eval_baseline": {"instance_quality": eval_base[0],
                          "fused_iou": eval_base[1]},
        "eval_tuned": {"instance_quality": eval_best[0],
                       "fused_iou": eval_best[1]},
        "eval_tuned_constrained": {"instance_quality": eval_best_c[0],
                                   "fused_iou": eval_best_c[1]},
    }
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "result.json").write_text(json.dumps(result, indent=2))
    print(json.dumps(result, indent=2), flush=True)


if __name__ == "__main__":
    main()
