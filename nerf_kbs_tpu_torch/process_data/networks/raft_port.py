"""The public RAFT checkpoints (``raft-things.pth``, ``raft-kitti.pth``, a
DataParallel ``module.`` prefix allowed) -> ``RAFT``'s state dict (the JAX
package's ``process_data/networks/raft_port.py``). Keys map by name:
``{fnet,cnet}.layerL.B`` -> ``res_{2(L-1)+B}`` (``downsample.0`` /
``downsample.1`` -> ``downsample_conv`` / ``norm3``),
``update_block.gru.conv{z,r,q}{1,2}`` -> ``conv{z,r,q}_{horiz,vert}``,
``update_block.flow_head.conv{1,2}`` -> ``flow_head_conv{1,2}``,
``update_block.mask.{0,2}`` -> ``mask_conv{1,2}``, and the rest as they
are."""

from __future__ import annotations

import re

import torch


def _rename(key: str) -> str | None:
    m = re.fullmatch(r"(fnet|cnet)\.layer(\d)\.(\d)\.(.+)", key)
    if m:
        enc, layer, block, rest = m.groups()
        rest = rest.replace("downsample.0", "downsample_conv").replace("downsample.1", "norm3")
        return f"{enc}.res_{2 * (int(layer) - 1) + int(block)}.{rest}"
    if re.fullmatch(r"(fnet|cnet)\.(conv1|norm1|conv2)\.\w+", key):
        return key
    if not key.startswith("update_block."):
        return None
    k = key[len("update_block."):]
    m = re.fullmatch(r"gru\.conv([zrq])([12])\.(\w+)", k)
    if m:
        g, idx, leaf = m.groups()
        return f"update.gru.conv{g}_{'horiz' if idx == '1' else 'vert'}.{leaf}"
    k = k.replace("flow_head.conv", "flow_head_conv").replace("mask.0", "mask_conv1")
    k = k.replace("mask.2", "mask_conv2")
    return f"update.{k}"


def raft_state_dict(sd: dict) -> dict:
    """A public-layout RAFT state dict -> ``RAFT``'s. Every key is renamed,
    none dropped: a norm's running statistics (a BatchNorm where ``RAFT``
    has an instance norm) make ``load_state_dict`` fail, not pass
    silently."""
    out = {}
    for key, v in sd.items():
        name = _rename(key.removeprefix("module."))
        if name is None:
            raise KeyError(f"{key}: not a RAFT weight")
        out[name] = v.float()
    return out


def load_raft_weights(path: str) -> dict:
    """A public RAFT checkpoint file -> ``RAFT``'s state dict."""
    return raft_state_dict(torch.load(path, map_location="cpu", weights_only=True))


def make_raft(iters: int, checkpoint=None, seed: int = 0):
    """A ``RAFT`` of ``iters`` iterations on the CPU: the checkpoint's
    weights, else seeded ones (``networks.init_weights``)."""
    from nerf_kbs_tpu_torch.process_data.networks import init_weights
    from nerf_kbs_tpu_torch.process_data.networks.raft import RAFT, RaftConfig

    raft = RAFT(RaftConfig(iters=iters))
    if checkpoint:
        raft.load_state_dict(load_raft_weights(checkpoint))
    else:
        init_weights(raft, torch.Generator().manual_seed(seed))
    return raft
