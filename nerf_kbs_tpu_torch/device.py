"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU. There
is no silent fallback: without CUDA and without ``device="cpu"`` they raise.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; anything else is taken as
    given. Raises RuntimeError when CUDA is asked for (explicitly or by
    default) and is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch "
            "path on the CPU"
        )
    return dev
