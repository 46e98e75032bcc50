"""ctypes bindings of the host sampler (``ray_sampler.cpp``), the
counterpart of the JAX package's ``native/lib.py``.

The library is built at first use (``build.py``); a failed build raises,
and nothing falls back to another draw. Only what the datamanager calls is
ported: ``sample_ray_batch`` with optional depths. The JAX package's
``shuffle_indices``, ``gather_rows`` and masked-pixel rejection have no
caller there and are not ported (``ROADMAP.md``, "Not to port").
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

_lib = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
ABI_VERSION = 2


def _load():
    global _lib
    if _lib is not None:
        return _lib
    from nerf_kbs_tpu_torch.native.build import build

    lib = ctypes.CDLL(str(build()))
    lib.sample_ray_batch.argtypes = [_P, _P, _I64, _I64, _I64, _I64, ctypes.c_uint64, _P, _P, _P]
    lib.sample_ray_batch.restype = None
    lib.nkt_native_abi_version.argtypes = []
    lib.nkt_native_abi_version.restype = ctypes.c_int
    if lib.nkt_native_abi_version() != ABI_VERSION:
        raise RuntimeError(f"native sampler ABI {lib.nkt_native_abi_version()}, "
                           f"expected {ABI_VERSION}")
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the library is built and loaded (it is built here when
    missing; a failed build raises)."""
    return _load() is not None


def _ptr(a: Optional[np.ndarray]):
    return a.ctypes.data_as(_P) if a is not None else None


def sample_ray_batch(images: np.ndarray, batch: int, seed: int,
                     depths: Optional[np.ndarray] = None) -> dict:
    """``batch`` uniform random pixels (camera, row, column) of an (N, H, W,
    3) uint8 image stack: {'ray_indices' (B, 3) int32, 'image' (B, 3) f32 in
    [0, 1], with depths (N, H, W) also 'depth_image' (B, 1) f32}.
    Deterministic in ``seed`` at a fixed OpenMP thread count; the JAX
    package's native sampler draws the same pixels at the same count."""
    lib = _load()
    n, h, w, _ = images.shape
    if not (images.flags.c_contiguous and images.dtype == np.uint8):
        raise ValueError("images must be a C-contiguous uint8 (N, H, W, 3) array")
    # the C ABI reads raw row-major buffers: coerce dtype and layout here
    if depths is not None:
        depths = np.ascontiguousarray(depths, dtype=np.float32)
        if depths.shape != (n, h, w):
            raise ValueError(f"depths {depths.shape}, expected {(n, h, w)}")
    ray_indices = np.empty((batch, 3), np.int32)
    rgb = np.empty((batch, 3), np.float32)
    depth = np.empty((batch, 1), np.float32) if depths is not None else None
    lib.sample_ray_batch(_ptr(images), _ptr(depths), n, h, w, batch, ctypes.c_uint64(seed),
                         _ptr(ray_indices), _ptr(rgb), _ptr(depth))
    out = {"ray_indices": ray_indices, "image": rgb}
    if depths is not None:
        out["depth_image"] = depth
    return out
