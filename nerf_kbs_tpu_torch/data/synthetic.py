"""Synthetic camera rigs."""

from __future__ import annotations

import numpy as np


def orbit_cameras(n: int, radius: float = 1.6, h: int = 64, w: int = 64, f: float = 70.0):
    """n cameras on a tilted orbit looking at the origin (OpenGL convention).
    Returns a cameras_np dict."""
    c2ws = []
    for ang in np.linspace(0, 2 * np.pi, n, endpoint=False):
        origin = radius * np.array([np.cos(ang), np.sin(ang), 0.35 + 0.1 * np.sin(2 * ang)])
        z = origin / np.linalg.norm(origin)  # +z backward = away from target
        x = np.cross(np.array([0.0, 0.0, 1.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        c2ws.append(np.stack([x, y, z, origin], axis=1))
    return {
        "fx": np.full(n, f, np.float32),
        "fy": np.full(n, f, np.float32),
        "cx": np.full(n, w / 2, np.float32),
        "cy": np.full(n, h / 2, np.float32),
        "c2w": np.stack(c2ws).astype(np.float32),
        "width": np.full(n, w, np.int32),
        "height": np.full(n, h, np.int32),
    }
