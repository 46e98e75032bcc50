"""Synthetic micro-scene: analytic spheres rendered to images, orbit camera
rigs and a datamanager over them (NumPy only)."""

from __future__ import annotations

import dataclasses

import numpy as np

from nerf_kbs_tpu_torch.data.outputs import DataparserOutputs


@dataclasses.dataclass
class SphereScene:
    """A few lambertian spheres in the unit box, orbited by cameras."""

    centers: np.ndarray  # (M, 3)
    radii: np.ndarray  # (M,)
    colors: np.ndarray  # (M, 3)
    bg: np.ndarray  # (3,)

    @staticmethod
    def default() -> "SphereScene":
        return SphereScene(
            centers=np.array([[0.0, 0.0, 0.0], [0.35, 0.1, 0.2], [-0.3, -0.15, 0.1]]),
            radii=np.array([0.25, 0.12, 0.15]),
            colors=np.array([[0.9, 0.2, 0.2], [0.2, 0.85, 0.25], [0.25, 0.3, 0.9]]),
            bg=np.array([1.0, 1.0, 1.0]),
        )

    def trace(self, origins: np.ndarray, dirs: np.ndarray):
        """Analytic ray trace. origins/dirs (N, 3) -> rgb (N, 3), depth (N,),
        hit mask (N,). Lambertian shading from a fixed light direction."""
        n = origins.shape[0]
        best_t = np.full(n, np.inf)
        best_i = np.full(n, -1)
        for i, (c, r) in enumerate(zip(self.centers, self.radii)):
            oc = origins - c
            b = np.einsum("nd,nd->n", oc, dirs)
            disc = b**2 - (np.einsum("nd,nd->n", oc, oc) - r**2)
            t = -b - np.sqrt(np.maximum(disc, 0.0))
            valid = (disc > 0) & (t > 1e-3) & (t < best_t)
            best_t = np.where(valid, t, best_t)
            best_i = np.where(valid, i, best_i)
        hit = best_i >= 0
        pts = origins + dirs * np.where(hit, best_t, 0.0)[:, None]
        rgb = np.tile(self.bg, (n, 1))
        light = np.array([0.5, 0.7, 0.5])
        light = light / np.linalg.norm(light)
        for i, (c, col) in enumerate(zip(self.centers, self.colors)):
            sel = best_i == i
            if not sel.any():
                continue
            normal = pts[sel] - c
            normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
            lam = np.clip(normal @ light, 0.0, 1.0)[:, None]
            rgb[sel] = col * (0.35 + 0.65 * lam)
        depth = np.where(hit, best_t, 0.0)
        return rgb.astype(np.float32), depth.astype(np.float32), hit


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


def render_scene_images(scene: SphereScene, cams: dict) -> tuple[np.ndarray, np.ndarray]:
    """Render GT (N, H, W, 3) float images + (N, H, W) depth with the analytic
    tracer, using the same ray convention as cameras.generate_rays."""
    n = cams["c2w"].shape[0]
    h, w = int(cams["height"][0]), int(cams["width"][0])
    yy, xx = np.mgrid[0:h, 0:w]
    imgs, depths = [], []
    for i in range(n):
        px = (xx + 0.5 - cams["cx"][i]) / cams["fx"][i]
        py = (yy + 0.5 - cams["cy"][i]) / cams["fy"][i]
        d_cam = np.stack([px, -py, -np.ones_like(px)], -1).reshape(-1, 3)
        R = cams["c2w"][i, :3, :3]
        d_world = d_cam @ R.T
        d_world /= np.linalg.norm(d_world, axis=-1, keepdims=True)
        o = np.tile(cams["c2w"][i, :3, 3], (h * w, 1))
        rgb, depth, _ = scene.trace(o, d_world)
        imgs.append(rgb.reshape(h, w, 3))
        depths.append(depth.reshape(h, w))
    return np.stack(imgs), np.stack(depths)


class SyntheticDataManager:
    """Datamanager over the analytic sphere scene: no files, deterministic.
    Batches are NumPy: 'ray_indices' (B, 3) int32 (camera, row, col) and
    'image' (B, 3) f32. ``train_outputs`` / ``eval_outputs`` hold the camera
    arrays; the trainer turns them into Cameras on its device."""

    def __init__(self, num_cameras=12, h=64, w=64, rays_per_batch=1024, seed=0,
                 num_eval_cameras=2, with_depth=False):
        scene = SphereScene.default()
        all_cams = orbit_cameras(num_cameras + num_eval_cameras, h=h, w=w)
        imgs, depths = render_scene_images(scene, all_cams)
        self.scene = scene

        def split(d, sl):
            return {k: v[sl] for k, v in d.items()}

        # eval cameras evenly interleaved through the orbit: holding out a
        # contiguous sector would make eval an extrapolation task
        n_total = num_cameras + num_eval_cameras
        ev_idx = np.linspace(0, n_total - 1, num_eval_cameras + 2, dtype=int)[1:-1]
        ev = np.asarray(ev_idx)
        tr = np.setdiff1d(np.arange(n_total), ev)
        self._images = {"train": imgs[tr], "eval": imgs[ev]}
        self._depths = {"train": depths[tr], "eval": depths[ev]} if with_depth else None
        self._cams_np = {"train": split(all_cams, tr), "eval": split(all_cams, ev)}
        box = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]])
        self.train_outputs = DataparserOutputs([], self._cams_np["train"], box)
        self.eval_outputs = DataparserOutputs([], self._cams_np["eval"], box)
        self.rays_per_batch = rays_per_batch
        # next_train is seeded by its step argument: there is no internal rng
        # state, and a caller that passes a constant step gets the same batch
        self._seed = seed
        self.semantics = None

    def next_train(self, step: int) -> dict:
        imgs = self._images["train"]
        n, h, w = imgs.shape[:3]
        b = self.rays_per_batch
        # per-step seeding: a resumed run replays the identical batch stream
        rng = np.random.default_rng(self._seed * 1_000_003 + step)
        cam = rng.integers(0, n, b)
        row = rng.integers(0, h, b)
        col = rng.integers(0, w, b)
        batch = {
            "ray_indices": np.stack([cam, row, col], -1).astype(np.int32),
            "image": imgs[cam, row, col],
        }
        if self._depths is not None:
            batch["depth_image"] = self._depths["train"][cam, row, col][:, None]
        return batch

    def num_eval_images(self) -> int:
        return self._images["eval"].shape[0]

    def eval_image(self, idx: int) -> dict:
        out = {"image": self._images["eval"][idx]}
        if self._depths is not None:
            out["depth_image"] = self._depths["eval"][idx][..., None]
        return out
