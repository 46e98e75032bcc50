"""Image helpers: 8-bit conversion, the turbo depth colormap and a PNG
encoder from the standard library (no imaging package is needed)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

# polynomial approximation of the turbo colormap (Google AI blog, 2019)
_TURBO_R = np.array([0.13572138, 4.61539260, -42.66032258, 132.13108234,
                     -152.94239396, 59.28637943])
_TURBO_G = np.array([0.09140261, 2.19418839, 4.84296658, -14.18503333,
                     4.27729857, 2.82956604])
_TURBO_B = np.array([0.10667330, 12.64194608, -60.58204836, 110.36276771,
                     -89.90310912, 27.34824973])


def _poly(c: np.ndarray, x: np.ndarray) -> np.ndarray:
    y = np.zeros_like(x)
    for coef in c[::-1]:
        y = y * x + coef
    return y


def apply_depth_colormap(depth: np.ndarray, accumulation: np.ndarray | None = None) -> np.ndarray:
    """Turbo colormap of depth normalised between its 2nd and 98th
    percentiles, modulated by accumulation. (H, W[, 1]) -> (H, W, 3)."""
    d = depth[..., 0] if depth.ndim == 3 else depth
    lo, hi = float(np.percentile(d, 2)), float(np.percentile(d, 98))
    x = np.clip((d - lo) / max(hi - lo, 1e-10), 0.0, 1.0)
    img = np.clip(np.stack([_poly(_TURBO_R, x), _poly(_TURBO_G, x), _poly(_TURBO_B, x)], -1), 0, 1)
    if accumulation is not None:
        a = accumulation[..., 0] if accumulation.ndim == 3 else accumulation
        img = img * a[..., None]
    return img


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) float in [0, 1] -> 8-bit RGB PNG bytes."""
    rgb = to_uint8(img)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[r].tobytes() for r in range(h))  # filter 0 per row

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
