"""InMemoryDataManager: every frame of a train and an eval split decoded into
host memory up front, and uniform random pixel batches from them (the host
sampler, ``native``).

A train batch is a dict of NumPy arrays: 'ray_indices' int32 (B, 3) (camera,
row, col), 'image' f32 (B, 3) and, where the split has them, 'depth_image'
(B, 1), 'mask' (B, 1) and 'semantics_label' int32 (B,). Rays are made from
the indices on the device. Frames, masks and semantic maps are PNG or JPEG
files, read by suffix with ``utils.images``; depth is ``.npy`` or a 16-bit
PNG in the dataset's units, scaled into the scene's.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from nerf_kbs_tpu_torch import native
from nerf_kbs_tpu_torch.data.outputs import DataparserOutputs
from nerf_kbs_tpu_torch.utils.images import decode_png, read_image
from nerf_kbs_tpu_torch.utils.profiling import span, spanned


def _load_image(path: str) -> np.ndarray:
    return read_image(path, "RGB")


def load_depth(path: str, scale: float) -> np.ndarray:
    """A depth map from .npy or from a one-channel (16-bit) PNG, times
    ``scale``."""
    if path.endswith(".npy"):
        d = np.load(path)
    elif path.lower().endswith(".png"):
        with open(path, "rb") as f:
            d = decode_png(f.read())
        if d.ndim != 2:
            raise ValueError(f"depth file {path}: a depth PNG has one channel, not {d.shape[2]}")
    else:
        raise ValueError(f"depth file {path}: depth is read from .npy and .png files")
    return d.astype(np.float32) * scale


def _load_mask(path: str) -> np.ndarray:
    return (read_image(path, "L") > 0).astype(np.uint8)


@dataclasses.dataclass
class DataManagerConfig:
    train_num_rays_per_batch: int = 4096
    eval_num_rays_per_batch: int = 4096
    seed: int = 0
    num_workers: int = 16


class InMemoryDataManager:
    """All-frames-in-memory pixel sampler over a train and an eval split.
    ``train_outputs`` / ``eval_outputs`` hold the camera arrays; the trainer
    makes Cameras of them on its device."""

    def __init__(self, train_outputs: DataparserOutputs, eval_outputs: DataparserOutputs,
                 config: DataManagerConfig | None = None):
        self.config = DataManagerConfig() if config is None else config
        self.train_outputs = train_outputs
        self.eval_outputs = eval_outputs
        self.train_assets = self._load_split(train_outputs)
        self.eval_assets = self._load_split(eval_outputs)
        self.semantics = train_outputs.semantics

    def _load_split(self, out: DataparserOutputs) -> dict:
        if not out.image_filenames:
            raise ValueError(
                "the dataparser gave an empty split: with few frames a high "
                "train_split_fraction leaves no eval image; lower the fraction or "
                "widen the frame window")
        # depth in the poses' scaled units: the dataset's unit times the
        # parser's scale, or a euclidean depth loss compares metres with a
        # scene in [-1, 1]
        depth_scale = out.depth_unit_scale_factor * out.dataparser_scale
        with ThreadPoolExecutor(self.config.num_workers) as ex:
            images = list(ex.map(_load_image, out.image_filenames))
            depths = (list(ex.map(lambda p: load_depth(p, depth_scale), out.depth_filenames))
                      if out.depth_filenames else None)
            masks = list(ex.map(_load_mask, out.mask_filenames)) if out.mask_filenames else None
            sem_imgs = (list(ex.map(_load_image, out.semantics.filenames))
                        if out.semantics and out.semantics.filenames else None)
        assets = {"images": np.stack(images)}
        if depths is not None:
            assets["depths"] = np.stack(depths)
        if masks is not None:
            assets["masks"] = np.stack(masks)
        if sem_imgs is not None:
            assets["semantic_labels"] = np.stack(
                [self._colors_to_labels_np(s, out.semantics.colors) for s in sem_imgs])
        return assets

    @staticmethod
    def _colors_to_labels_np(sem_img: np.ndarray, class_colors: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 colour labels -> (H, W) int32 class ids, by the
        nearest class colour in L1."""
        flat = sem_img.reshape(-1, 3).astype(np.float32) / 255.0
        d = np.abs(flat[:, None, :] - class_colors[None, :, :]).sum(-1)
        return d.argmin(1).astype(np.int32).reshape(sem_img.shape[:2])

    @spanned("next_train")
    def next_train(self, step: int) -> dict:
        """The batch of ``step``: uniform (camera, row, col) draws from the
        host sampler (``native.sample_ray_batch``, seed ``seed * 1_000_003 +
        step``), as the JAX package's datamanager draws them. Mask values
        ride along as supervision weights; masked pixels are not rejected.
        Depth comes from the sampler, masks and semantic labels are gathered
        at the drawn pixels."""
        a = self.train_assets
        with span("next_train.sample"):
            batch = native.sample_ray_batch(a["images"], self.config.train_num_rays_per_batch,
                                            seed=self.config.seed * 1_000_003 + step,
                                            depths=a.get("depths"))
        cam, row, col = batch["ray_indices"].T
        if "masks" in a:
            batch["mask"] = a["masks"][cam, row, col][:, None].astype(np.float32)
        if "semantic_labels" in a:
            batch["semantics_label"] = a["semantic_labels"][cam, row, col]
        return batch

    def num_eval_images(self) -> int:
        return self.eval_assets["images"].shape[0]

    def eval_image(self, idx: int) -> dict:
        """The ground truth of eval camera ``idx``, whole images."""
        a = self.eval_assets
        out = {"image": a["images"][idx].astype(np.float32) / 255.0}
        if "depths" in a:
            out["depth_image"] = a["depths"][idx][..., None]
        if "masks" in a:
            out["mask"] = a["masks"][idx][..., None].astype(np.float32)
        if "semantic_labels" in a:
            out["semantics_label"] = a["semantic_labels"][idx]
        return out

    def next_eval_batch(self, step: int) -> dict:
        """Random eval rays of ``step``, seeded by it as ``next_train`` is."""
        a = self.eval_assets
        n, h, w = a["images"].shape[:3]
        b = self.config.eval_num_rays_per_batch
        rng = np.random.default_rng(self.config.seed * 2_000_003 + step)
        cam = rng.integers(0, n, b)
        row = rng.integers(0, h, b)
        col = rng.integers(0, w, b)
        return {"ray_indices": np.stack([cam, row, col], -1).astype(np.int32),
                "image": a["images"][cam, row, col].astype(np.float32) / 255.0}
