"""The JAX package's flax variables of the preprocessing networks, as nested
dicts of NumPy arrays, -> the port's state dicts (CPU float32 tensors).

The port's modules carry the flax modules' names, so leaves map by path:
a convolution kernel HWIO -> OIHW, a ``Dense`` kernel (in, out) -> (out,
in), the attention's per-head kernels (C, heads, head_dim) for q, k, v and
(heads, head_dim, C) for the output -> (C, C), ``scale`` -> ``weight``, and
BatchNorm's ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` /
``running_var``."""

from __future__ import annotations

import numpy as np
import torch


def _leaf(name: str, path: tuple, v: np.ndarray) -> tuple[str, np.ndarray]:
    v = np.asarray(v, np.float32)
    if name == "kernel":
        if v.ndim == 4:
            return "weight", v.transpose(3, 2, 0, 1)
        if v.ndim == 3:  # attention: (C, heads, hd), or (heads, hd, C) for "out"
            c = v.shape[-1] if path[-1] == "out" else v.shape[0]
            return "weight", v.reshape(-1, c).T if path[-1] == "out" else v.reshape(c, -1).T
        return "weight", v.T
    if name == "bias":
        return "bias", v.reshape(-1)
    return {"scale": "weight", "mean": "running_mean", "var": "running_var"}[name], v


def state_dict_from_flax(*trees: dict, prefix: str = "") -> dict:
    """Walk flax collections (``params``, then ``batch_stats``) into one
    state dict, every key under ``prefix``."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                name, arr = _leaf(k, path, v)
                out[prefix + ".".join(path + (name,))] = torch.tensor(arr)

    for tree in trees:
        walk(tree, ())
    return out


def resnet_from_jax(variables: dict, prefix: str = "") -> dict:
    """``ResNetEncoder``: {"params", "batch_stats"}."""
    return state_dict_from_flax(variables["params"], variables["batch_stats"], prefix=prefix)


def monodepth2_from_jax(variables: dict) -> dict:
    """``Monodepth2``: {"encoder", "depth_decoder", "pose_encoder",
    "pose_decoder"}, each a flax variables dict."""
    out = {}
    for net in ("encoder", "pose_encoder"):
        out |= resnet_from_jax(variables[net], prefix=f"{net}.")
    for net in ("depth_decoder", "pose_decoder"):
        out |= state_dict_from_flax(variables[net]["params"], prefix=f"{net}.")
    return out


def raft_from_jax(variables: dict) -> dict:
    """``RAFT``: {"fnet", "cnet", "update"}, each {"params": ...}."""
    return {k: v for net in ("fnet", "cnet", "update")
            for k, v in state_dict_from_flax(variables[net]["params"], prefix=f"{net}.").items()}


def segmenter_from_jax(variables: dict) -> dict:
    """``InstanceSegmenter``: {"params": ...}."""
    return state_dict_from_flax(variables["params"])


def inpaint_from_jax(variables: dict) -> dict:
    """``InpaintGenerator``: {"params": ...}."""
    return state_dict_from_flax(variables["params"])
