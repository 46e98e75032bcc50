"""RAFT drivers (the JAX package's ``process_data/raft_driver.py``).

- ``extract_flows``: flow over a frame sequence. Writes flow_fwd/<stem_i>.npy
  (i -> i + 1), flow_bwd/<stem_i+1>.npy (i + 1 -> i) as (H, W, 2) float32
  (dx, dy), and a colour coding of each forward flow in flow_viz/, the asset
  layout ``metadata.json`` points at. Frames are resized to the working size
  and not padded: its width and height must be multiples of 8 (640 x 192 by
  default).
- Fine-tuning: ``make_raft_train_state`` and ``make_raft_train_step``, the
  sequence loss over every iteration's flow under AdamW (optax's
  semantics) with a linear one-cycle learning rate, behind a global-norm
  clip; data parallel over processes with a ``parallel.mesh.Mesh``."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from nerf_kbs_tpu_torch.device import resolve_device
from nerf_kbs_tpu_torch.process_data import networks
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


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RaftTrainConfig:
    lr: float = 4e-4
    weight_decay: float = 1e-4
    epsilon: float = 1e-8
    clip: float = 1.0
    num_steps: int = 100_000
    iters: int = 12
    gamma: float = 0.8
    seed: int = 0


def linear_onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                             pct_final: float = 0.85, div_factor: float = 25.0,
                             final_div_factor: float = 1e4) -> Callable[[int], float]:
    """optax's ``linear_onecycle_schedule``: from peak / div_factor up to
    peak at ``pct_start`` of the steps, down to peak / div_factor at
    ``pct_final``, then down to peak / div_factor / final_div_factor at
    ``transition_steps``, linearly; constant after."""
    if transition_steps <= 0:
        raise ValueError("a linear onecycle schedule needs transition_steps > 0")
    bounds = (0, int(pct_start * transition_steps), int(pct_final * transition_steps),
              transition_steps)
    values = np.cumprod([peak_value / div_factor, div_factor, 1.0 / div_factor,
                         1.0 / final_div_factor])

    def schedule(count: int) -> float:
        for lo, hi, a, b in zip(bounds[:-1], bounds[1:], values[:-1], values[1:]):
            if lo <= count < hi:
                return float(a + (count - lo) / (hi - lo) * (b - a))
        return float(values[-1])

    return schedule


class ClippedAdamW:
    """optax's ``chain(clip_by_global_norm(clip), adamw(schedule, eps,
    weight_decay))`` on a module's parameters: the gradients are scaled by
    clip / norm when their global norm reaches ``clip``, then AdamW (b1 0.9,
    b2 0.999, decoupled weight decay on every parameter) steps with the
    schedule's rate at the update's count (0 for the first)."""

    def __init__(self, params, schedule: Callable[[int], float], clip: float, eps: float,
                 weight_decay: float):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.clip = clip
        self.count = 0
        self.optimizer = torch.optim.AdamW(self.params, lr=schedule(0), betas=(0.9, 0.999),
                                           eps=eps, weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.optimizer.zero_grad()

    def step(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < self.clip, 1.0, self.clip / norm)
        for g in grads:
            g.mul_(scale)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.count)
        self.optimizer.step()
        self.count += 1


def make_raft_train_state(cfg: RaftTrainConfig, restore_ckpt: Optional[str] = None,
                          device=None):
    """(raft, tx): a ``RAFT`` of ``cfg.iters`` iterations on ``device``
    (CUDA unless "cpu") with a public checkpoint's weights, else seeded ones
    (``cfg.seed``), and its ``ClippedAdamW`` with the one-cycle schedule
    over ``num_steps + 100`` steps peaking at ``lr`` after 5%."""
    raft = make_raft(cfg.iters, restore_ckpt, cfg.seed).to(resolve_device(device)).train()
    sched = linear_onecycle_schedule(cfg.num_steps + 100, cfg.lr, pct_start=0.05)
    return raft, ClippedAdamW(raft.parameters(), sched, cfg.clip, cfg.epsilon, cfg.weight_decay)


def make_raft_train_step(raft, tx: ClippedAdamW, cfg: RaftTrainConfig, mesh=None):
    """step(batch) -> (loss, metrics): one update of ``raft`` in place.
    batch: img1, img2 (B, 3, H, W) in [0, 1], flow (B, 2, H, W), valid (B,
    H, W), on the network's device. With a ``mesh`` (``parallel.mesh``) the
    batch is this rank's rows of the global batch: the loss and metrics are
    the global batch's, and the gradients are averaged over the ranks
    before the global-norm clip, as the gradient of the global loss is
    clipped in one process. The convolutions run on cuDNN's deterministic
    algorithms."""
    from nerf_kbs_tpu_torch.parallel.mesh import Mesh, all_reduce_grads, global_batch
    from nerf_kbs_tpu_torch.process_data.networks.raft import sequence_loss

    if mesh is None:  # one process: no collective
        mesh = Mesh(0, 1, next(raft.parameters()).device, None)

    def step(batch: dict):
        with networks.deterministic_convolutions():
            with global_batch(mesh):
                flows = raft.compute_flow(batch["img1"], batch["img2"], iters=cfg.iters,
                                          all_iters=True)
                loss, metrics = sequence_loss(flows, batch["flow"], batch["valid"], cfg.gamma)
            tx.zero_grad()
            loss.backward()
        all_reduce_grads(mesh, tx.params)
        tx.step()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    return step
