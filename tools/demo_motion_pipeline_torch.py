"""Motion-mask pipeline demo on a dynamic scene with exact ground truth, on
the PyTorch port (the counterpart of tools/demo_motion_pipeline.py).

Runs the whole chain (process_data/exact_chain.py: exact depth and ego pose
-> pose2flow -> rigid flow; exact dynamic flow as the optical flow;
moving_probability -> hard_motion_mask -> instances_from_components ->
per_object_fusion) on the dynamic street scene, scores the combined dynamic
mask by IoU against the true one, and checks the geometry (the rigid flow
matches the optical flow on static pixels). Writes overlay_%03d.png (red:
predicted dynamic, green: missed), mask_%03d.png and result.json with the
JAX tool's keys under --out.

The flows and probabilities run on the CUDA card unless --platform cpu (the
JAX tool defaults to the CPU); without CUDA it raises.

Usage: python tools/demo_motion_pipeline_torch.py --frames 8 --h 188 --w 621
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

import numpy as np

from nerf_kbs_tpu_torch.process_data.exact_chain import exact_motion_chain
from nerf_kbs_tpu_torch.utils.images import encode_png_u8
from study_field_torch import platform_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--h", type=int, default=188)
    ap.add_argument("--w", type=int, default=621)
    ap.add_argument("--th", type=float, default=0.3)
    ap.add_argument("--out", default="outputs/motion_pipeline_demo")
    ap.add_argument("--platform", default=None, help="cpu; the CUDA card if unset")
    args = ap.parse_args(argv)
    dev = platform_device(args.platform)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    res = exact_motion_chain(args.frames, args.h, args.w, args.th, device=dev)
    for i, (mask, over) in enumerate(zip(res["masks"], res["overlays"])):
        (out / f"overlay_{i:03d}.png").write_bytes(encode_png_u8((over * 255).astype(np.uint8)))
        (out / f"mask_{i:03d}.png").write_bytes(encode_png_u8(mask * 255))

    result = {
        "mean_iou": res["mean_iou"],
        "per_frame_iou": res["per_frame_iou"],
        # per-pair medians, aggregated both ways
        "median_static_flow_err_px": res["median_static_flow_err_px"],
        "mean_of_median_static_flow_err_px": res["mean_of_median_static_flow_err_px"],
        "frames": args.frames,
    }
    print(json.dumps(result), flush=True)
    (out / "result.json").write_text(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
