"""End-to-end flow-supervision study on the PyTorch port (the counterpart of
tools/study_flow.py).

Trains nerfacto-tpu's field (tri-basis Fourier field, proposals (128, 48))
on the synthetic street scene through the chunked stream pipeline
(ImageMetadata -> ChunkedStreamDataManager with_flow -> Trainer), with the
exact ray-traced forward flow as supervision, and compares flow_loss_mult =
0 against 1e-3 on held-out depth accuracy. The induced-flow loss
(ops/losses.induced_flow: unproject the rendered depth, reproject it into
the neighbour camera) supervises geometry, so the expected signature of it
working is a lower scale-and-shift-aligned eval depth MSE at equal steps.

The port's Trainer dispatches every step on its own: the JAX tool's
steps_per_dispatch=25 has no counterpart. On the card the fields run in bf16
on the fused kernels (A 2 / B 1 / C 2 / D 1 a step), on the CPU in f32. Runs
on the CUDA card unless --platform cpu; without CUDA it raises. Each arm's
Trainer writes under outputs/flow_study of the working directory.

Usage: python tools/study_flow_torch.py --steps 1500 --batch 4096
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

from nerf_kbs_tpu_torch.data.dataparsers.kitti import KittiDataParserConfig
from nerf_kbs_tpu_torch.data.image_metadata import ImageMetadata
from nerf_kbs_tpu_torch.data.stream import ChunkedStreamDataManager, StreamConfig
from nerf_kbs_tpu_torch.data.synthetic_kitti import write_dataset
from nerf_kbs_tpu_torch.engine.optimizers import OptimizerConfig
from nerf_kbs_tpu_torch.engine.trainer import Trainer, TrainerConfig
from nerf_kbs_tpu_torch.models import nerfacto
from study_field_torch import build_kernels, compute_dtype, platform_device


def build_items(data_dir, parser_out, frame_ids, all_train_ids, out_dir):
    """ImageMetadata list for ``frame_ids`` with parser-space (scaled GL)
    poses; the forward flow attaches only when frame i+1 is also a usable
    neighbour."""
    pos_of = {f: k for k, f in enumerate(frame_ids)}
    items = []
    for k, f in enumerate(frame_ids):
        flow_path = out_dir / "flow_fwd" / f"{f:06}.npy"
        nbr = pos_of.get(f + 1)
        items.append(
            ImageMetadata(
                image_path=str(out_dir / "00" / f"{f:06}.png"),
                c2w=parser_out["c2w"][k],
                W=int(parser_out["width"][k]),
                H=int(parser_out["height"][k]),
                intrinsics=np.array(
                    [parser_out["fx"][k], parser_out["fy"][k],
                     parser_out["cx"][k], parser_out["cy"][k]], np.float32
                ),
                image_index=k,
                time=f / max(len(all_train_ids), 1),
                video_id=0,
                depth_path=str(out_dir / "depth" / f"{f:06}.npy"),
                mask_path=str(out_dir / "mask" / f"{f:06}.png"),
                forward_flow_path=(
                    str(flow_path) if nbr is not None and flow_path.exists()
                    else None
                ),
                forward_neighbor_index=nbr,
            )
        )
    return items


def run_one(flow_mult, items_train, items_eval, steps, batch, device):
    dm = ChunkedStreamDataManager(
        items_train, items_eval,
        StreamConfig(
            items_per_chunk=4_000_000, train_num_rays_per_batch=batch,
            with_depth=False, with_flow=flow_mult > 0,
        ),
    )
    cfg = nerfacto.NerfactoConfig(
        num_images=len(items_train),
        field_type="fourier",
        fourier_basis="tri",
        hidden_dim=128,
        num_layers=3,
        base_res=4,
        max_res=64,
        fourier_anneal_steps=1000,
        appearance_embedding_dim=0,
        num_proposal_samples_per_ray=(128, 48),
        compute_dtype=compute_dtype(device),
        flow_loss_mult=flow_mult,
    )
    tc = TrainerConfig(
        method_name=f"flow{flow_mult}", output_dir="outputs/flow_study",
        max_num_iterations=steps,
        steps_per_eval_image=10**9, steps_per_eval_all_images=10**9,
        steps_per_save=10**9, log_every=500,
        # eval chunks no larger than one frame: the padding of a smaller
        # frame's one chunk would be work thrown away
        eval_num_rays_per_chunk=min(1 << 15, items_train[0].H * items_train[0].W),
    )
    opts = {
        "proposal_networks": OptimizerConfig(lr=1e-3, eps=1e-15, max_norm=1.0),
        "fields": OptimizerConfig(lr=1e-3, eps=1e-15, max_norm=1.0),
    }
    build_kernels(cfg, device)
    try:
        tr = Trainer(tc, cfg, opts, dm, device=device)
        tr.train()
        metrics = tr.eval_all_images()
    finally:
        dm.close()
    return metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--h", type=int, default=188)
    ap.add_argument("--w", type=int, default=621)
    ap.add_argument("--data", default="outputs/kitti_syn_flow")
    ap.add_argument("--platform", default=None, help="cpu; the CUDA card if unset")
    args = ap.parse_args(argv)
    dev = platform_device(args.platform)

    out = Path(args.data)
    if not (out / "00").exists():
        print("generating dataset with exact flow ...", flush=True)
        write_dataset(out, n_frames=args.frames, h=args.h, w=args.w,
                      write_flow=True)

    def parse(split):
        cfg = KittiDataParserConfig(
            data_dir=str(out), sequence="00", first_frame=0,
            last_frame=args.frames, image_height=args.h, image_width=args.w,
            train_split_fraction=0.9, use_depth=True,
            depth_unit_scale_factor=1.0,
        )
        do = cfg.parse(split)
        ids = [int(Path(p).stem) for p in do.image_filenames]
        return do.cameras_np, ids

    cams_tr, ids_tr = parse("train")
    cams_ev, ids_ev = parse("val")
    items_tr = build_items(out, cams_tr, ids_tr, ids_tr, out)
    items_ev = build_items(out, cams_ev, ids_ev, ids_tr, out)

    results = {}
    for mult in (0.0, 1e-3):
        m = run_one(mult, items_tr, items_ev, args.steps, args.batch, dev)
        print(f"flow_loss_mult={mult}: {m}", flush=True)
        results[str(mult)] = m
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
