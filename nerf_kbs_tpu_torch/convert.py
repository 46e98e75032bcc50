"""Parameter import from the JAX package's layout.

The JAX nerfacto parameters, as nested dicts and lists with NumPy leaves
(``{"fields": {<encoding>, "base_mlp": {"w", "b"}, "rgb_mlp", ...},
"proposal_networks": [{<encoding>, "mlp"}, ...]}``), map leaf for leaf onto
the port's, whichever encoding and heads they hold: the encoding is
"fourier_B" (3, H), "hash_table" (the flat feature-major 1-D table) or
"cp_tables" (a list of (3, res + 1, F) tables); the heads are
"appearance_emb", "semantic_mlp", "transient_emb", "transient_mlp", the
three transient heads and "pred_normal_mlp". Vanilla NeRF's tree
(``{"fields": {"coarse", "fine": {"base", "density_head", "rgb_head"}},
"temporal_distortion"}``) maps the same way; a skip layer's weight is
(width + in_dim, out) in both packages. The camera optimizer's tangents,
"camera_opt" (num_images, 6), come across as they are. The port keeps every weight as
(in, out), the layout the kernels read, so no leaf is reshaped or transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from nerf_kbs_tpu_torch.device import resolve_device


def params_from_jax(tree, device=None):
    """The same tree with every leaf a float32 tensor on ``device`` (CUDA
    unless ``device="cpu"``)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.tensor(np.asarray(node, np.float32), device=dev)

    return conv(tree)


def opt_state_from_jax(group_states: dict, device=None) -> dict:
    """Optimizer state for ``GroupOptimizer.load_state_dict`` from optax
    Adam's per group: ``{group: {"mu": tree, "nu": tree, "count": int}}`` with
    NumPy leaves shaped like the group's parameters."""
    return {
        g: {"mu": params_from_jax(st["mu"], device), "nu": params_from_jax(st["nu"], device),
            "count": int(st["count"])}
        for g, st in group_states.items()
    }
