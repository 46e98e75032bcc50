"""Regenerate the synthetic datasets of the studies with the PyTorch port's
writers (the counterpart of tools/regen_data.py): outputs/kitti_syn (40
frames of 375x1242), outputs/vkitti_syn and outputs/kitti_dyn under --root
(the repository root by default). --frames, --h and --w, where given, cut
all three datasets to that many frames of that size.

The writers are host NumPy; like every port tool it asks for the CUDA card
unless --platform cpu, and raises without CUDA.

Usage: python tools/regen_data_torch.py
"""

from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import argparse

from nerf_kbs_tpu_torch.data.synthetic_kitti import (
    write_dataset,
    write_dynamic_dataset,
    write_vkitti_dataset,
)
from study_field_torch import platform_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO), help="the datasets go under <root>/outputs")
    ap.add_argument("--frames", type=int, default=None, help="frames of every dataset")
    ap.add_argument("--h", type=int, default=None, help="image height of every dataset")
    ap.add_argument("--w", type=int, default=None, help="image width of every dataset")
    ap.add_argument("--platform", default=None, help="cpu; the CUDA card if unset")
    args = ap.parse_args(argv)
    platform_device(args.platform)
    root = Path(args.root)
    cut = {k: v for k, v in (("n_frames", args.frames), ("h", args.h), ("w", args.w))
           if v is not None}
    write_dataset(root / "outputs/kitti_syn", **{"n_frames": 40, "h": 375, "w": 1242, **cut})
    print("kitti_syn written", flush=True)
    write_vkitti_dataset(root / "outputs/vkitti_syn", **cut)
    print("vkitti_syn written", flush=True)
    write_dynamic_dataset(root / "outputs/kitti_dyn", **cut)
    print("kitti_dyn written", flush=True)
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
