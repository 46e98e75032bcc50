"""Motion-mask ops (the JAX package's ``process_data/motion_mask.py``): the
moving probability from optical against rigid flow, the hard mask, the
monodepth flip post-processing and the depth conversion, on tensors; the
instance fusion, connected components, panoptic masks, morphology and mask
rendering on the host in NumPy and ``scipy.ndimage``.

``erode_mask`` and ``dilate_mask`` give OpenCV's pixels (``utils.images``
``erode`` / ``dilate``)."""

from __future__ import annotations

import numpy as np
import torch

from nerf_kbs_tpu_torch.utils import images

# KITTI-STEP semantic category ids taken as dynamic (car, truck, bus, person,
# bicycle)
DYNAMIC_CATEGORIES = (13, 14, 15, 16, 18)

KITTI_STEREO_SCALE = 5.37  # metric scale presets of the monodepth2 stereo
TUM_STEREO_SCALE = 0.747  # models on KITTI and TUM


def moving_probability(optical_flow: torch.Tensor, rigid_flow: torch.Tensor) -> torch.Tensor:
    """Per-pixel probability of non-rigid motion in [0, 1]. Flows (2, H, W):
    each is divided by its own largest component, then the difference of
    their norms is min-max normalised."""
    o = optical_flow / optical_flow.abs().max().clamp(min=1e-12)
    r = rigid_flow / rigid_flow.abs().max().clamp(min=1e-12)
    d = torch.linalg.vector_norm(o, dim=0) - torch.linalg.vector_norm(r, dim=0)
    return (d - d.min()) / (d.max() - d.min()).clamp(min=1e-12)


def cosine_flow_distance(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(1 - cos_sim) / 2 between flow fields (2, H, W) -> (H, W) in [0, 1]."""
    na = a / (torch.linalg.vector_norm(a, dim=0) + eps)
    nb = b / (torch.linalg.vector_norm(b, dim=0) + eps)
    return (1.0 - (na * nb).sum(0)) / 2.0


def hard_motion_mask(moving_prob: torch.Tensor, threshold: float = 0.3) -> torch.Tensor:
    """uint8 mask, 1 = moving."""
    return (moving_prob > threshold).to(torch.uint8)


def fuse_instance_motion_mask(instance_mask: np.ndarray, motion_mask: np.ndarray,
                              m_th: float = 0.6) -> tuple[np.ndarray, np.ndarray]:
    """Fuse a (possibly soft, 1 = background) instance mask with a binary
    motion mask: the whole object is dynamic when its moving share exceeds
    ``m_th``, else only its moving pixels. The instance mask is resized to
    the motion mask's shape (nearest) if needed. -> (final 1 = dynamic,
    object 1 = object)."""
    ins = 1 - (np.asarray(instance_mask) > 0.5).astype(np.uint8)
    motion = np.asarray(motion_mask).astype(np.float32)
    if ins.shape != motion.shape:
        from scipy.ndimage import zoom

        ins = zoom(ins, (motion.shape[0] / ins.shape[0], motion.shape[1] / ins.shape[1]),
                   order=0)
    ratio = float((motion * ins).sum()) / max(float(ins.sum()), 1e-12)
    final = ins if ratio > m_th else ins * motion
    return final.astype(np.uint8), ins


def per_object_fusion(instance_labels: np.ndarray, motion_mask: np.ndarray,
                      m_th: float = 0.6) -> np.ndarray:
    """``fuse_instance_motion_mask`` for each id of an integer instance map
    (0 = background). Returns 1 = STATIC."""
    final = np.zeros_like(motion_mask, dtype=np.uint8)
    motion = motion_mask.astype(np.float32)
    for n in np.unique(instance_labels):
        if n <= 0:
            continue
        obj = (instance_labels == n).astype(np.float32)
        ratio = float((motion * obj).sum()) / max(float(obj.sum()), 1e-12)
        final |= (obj if ratio > m_th else obj * motion).astype(np.uint8)
    return 1 - final


def instances_from_components(mask: np.ndarray, min_area: int = 64,
                              close_size: int = 7) -> np.ndarray:
    """Instances without a network: connected components of a binary mask
    after a morphological closing, blobs under ``min_area`` dropped ->
    int32 labels (0 = background)."""
    from scipy import ndimage

    m = np.asarray(mask) > 0
    if close_size > 1:
        m = ndimage.binary_closing(m, structure=np.ones((close_size, close_size), bool))
    labels, n = ndimage.label(m)
    out = np.zeros_like(labels, dtype=np.int32)
    nxt = 1
    for i in range(1, n + 1):
        blob = labels == i
        if blob.sum() >= min_area:
            out[blob] = nxt
            nxt += 1
    return out


def post_process_disparity(l_disp: torch.Tensor, r_disp: torch.Tensor) -> torch.Tensor:
    """Monodepth's flip fusion of the disparities of an image and of its
    horizontal flip (flipped back), (B, H, W) each."""
    w = l_disp.shape[-1]
    m = 0.5 * (l_disp + r_disp)
    l = torch.linspace(0, 1, w, device=l_disp.device)[None, None, :]
    l_mask = 1.0 - (20 * (l - 0.05)).clamp(0, 1)
    r_mask = l_mask.flip(-1)
    return r_mask * l_disp + l_mask * r_disp + (1.0 - l_mask - r_mask) * m


def disp_to_depth(disp: torch.Tensor, min_depth: float = 0.1,
                  max_depth: float = 100.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Sigmoid disparity -> (scaled disparity in [1/max_depth, 1/min_depth],
    depth = 1/scaled)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled = min_disp + (max_disp - min_disp) * disp
    return scaled, 1.0 / scaled


def metric_depth(depth: torch.Tensor, camera: str = "kitti") -> torch.Tensor:
    """The camera's metric scale, then a clamp to [1e-3, 80]."""
    scale = {"kitti": KITTI_STEREO_SCALE, "tum": TUM_STEREO_SCALE}.get(camera, 1.0)
    return (depth * scale).clamp(1e-3, 80.0)


def panoptic_to_dynamic_mask(panoptic: np.ndarray,
                             categories: tuple[int, ...] = DYNAMIC_CATEGORIES) -> np.ndarray:
    """KITTI-STEP panoptic annotation (R = semantic category) -> uint8 mask of
    the dynamic classes."""
    sem = panoptic[..., 0] if panoptic.ndim == 3 else panoptic
    return np.isin(sem, categories).astype(np.uint8)


def erode_mask(mask: np.ndarray, radius: int = 10) -> np.ndarray:
    """Erosion by OpenCV's elliptic element of size 2 * radius + 1."""
    return images.erode(mask.astype(np.uint8), images.ellipse_offsets(2 * radius + 1))


def dilate_mask(mask: np.ndarray, size: int = 10, iterations: int = 4) -> np.ndarray:
    """Dilation by OpenCV's size x size cross, ``iterations`` times."""
    return images.dilate(mask.astype(np.uint8), images.cross_offsets(size), iterations)


def render_mask_on_image(image: np.ndarray, mask: np.ndarray,
                         color: tuple[int, int, int] = (255, 255, 255),
                         mask_weight: float = 0.7) -> np.ndarray:
    """Alpha-blend a coloured mask over a uint8 image."""
    out = image.astype(np.float32).copy()
    m = mask > 0
    out[m] = out[m] * (1 - mask_weight) + np.array(color, np.float32) * mask_weight
    return out.astype(np.uint8)
