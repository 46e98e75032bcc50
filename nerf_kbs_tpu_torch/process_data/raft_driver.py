"""RAFT flow extraction over a frame sequence (the JAX package's
``process_data/raft_driver.py``, ``extract_flows``; its training side is
not ported yet). Writes flow_fwd/<stem_i>.npy (i -> i + 1), flow_bwd/
<stem_i+1>.npy (i + 1 -> i) as (H, W, 2) float32 (dx, dy), and a colour
coding of each forward flow in flow_viz/, the asset layout ``metadata.json``
points at. Frames are resized to the working size and not padded: its
width and height must be multiples of 8 (640 x 192 by default)."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from nerf_kbs_tpu_torch.device import resolve_device
from nerf_kbs_tpu_torch.process_data.motion_mask_driver import list_frames, load_frame
from nerf_kbs_tpu_torch.process_data.networks.raft_port import make_raft
from nerf_kbs_tpu_torch.process_data.warp import flow_to_image
from nerf_kbs_tpu_torch.utils.images import encode_png_u8


@dataclasses.dataclass
class FlowExtractConfig:
    image_dir: str = "images"
    output_dir: str = "motion"
    iters: int = 20
    checkpoint: Optional[str] = None
    width: int = 640
    height: int = 192
    both_directions: bool = True
    seed: int = 0


@torch.no_grad()
def extract_flows(cfg: FlowExtractConfig, max_frames: Optional[int] = None, device=None) -> dict:
    """-> {"pairs", "output"}."""
    dev = resolve_device(device)
    frames = list_frames(cfg.image_dir)
    if max_frames:
        frames = frames[:max_frames]
    raft = make_raft(cfg.iters, cfg.checkpoint, cfg.seed).to(dev).eval()
    out = Path(cfg.output_dir)
    for sub in ("flow_fwd", "flow_bwd", "flow_viz"):
        (out / sub).mkdir(parents=True, exist_ok=True)

    def flow(a, b) -> np.ndarray:
        return raft.compute_flow(a, b, iters=cfg.iters)[0].permute(1, 2, 0).cpu().numpy()

    n = 0
    b = None
    for i in range(len(frames) - 1):
        a = b if b is not None else _frame(frames[i], cfg, dev)
        b = _frame(frames[i + 1], cfg, dev)
        fwd = flow(a, b)
        np.save(out / "flow_fwd" / f"{frames[i].stem}.npy", fwd)
        (out / "flow_viz" / f"{frames[i].stem}.png").write_bytes(encode_png_u8(flow_to_image(fwd)))
        if cfg.both_directions:
            np.save(out / "flow_bwd" / f"{frames[i + 1].stem}.npy", flow(b, a))
        n += 1
    return {"pairs": n, "output": str(out)}


def _frame(path, cfg: FlowExtractConfig, dev) -> torch.Tensor:
    return torch.as_tensor(load_frame(path, cfg.width, cfg.height), device=dev).permute(2, 0, 1)[None]
