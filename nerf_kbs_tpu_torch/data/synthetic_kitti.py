"""A street scene, ray traced in NumPy and written to disk in the KITTI and
the Virtual KITTI 2 layouts (the JAX package's ``write_dataset``,
``write_dynamic_dataset`` and ``write_vkitti_dataset`` and what they call).

The scene is a textured road with building facades, parked cars and sky;
the dynamic scene adds two moving cars. ``write_dataset`` (static) and
``write_dynamic_dataset`` write the layout the KITTI dataparser reads:

    out_dir/calib.txt               P0..P3 projections (KITTI odometry calib)
    out_dir/00.txt                  cam0 poses, one 3x4 row a frame
    out_dir/00/000000.png           left colour frames
    out_dir/depth/000000.npy        z-depth in metres (float32)
    out_dir/sem/000000.png          semantic colour maps
    out_dir/mask/000000.png         static-pixel masks (255 static, 0 moving)
    out_dir/flow_fwd/000000.npy     exact forward flow to the next frame, (H,
                                    W, 3): u, v, valid (the dynamic scene
                                    always, the static one with write_flow)
    out_dir/semantics_list.txt      Category,R,G,B

``write_vkitti_dataset`` writes the static scene in the layout the vKITTI
dataparser reads: intrinsic.txt and extrinsic.txt, frames/rgb/Camera_0/
rgb_00000.jpg (quality 97) and frames/depth/Camera_0/depth_00000.png (16-bit
centimetres).

PNGs and JPEGs are written with ``utils.images`` and ``utils.jpeg``; the
flow files are what ``data.image_metadata.ImageMetadata`` reads.

Geometry is axis-aligned in the KITTI cam0 convention: x right, y down, z
forward; the ground is the plane y = CAM_HEIGHT.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from nerf_kbs_tpu_torch.utils.images import encode_png_u8, encode_png_u16
from nerf_kbs_tpu_torch.utils.jpeg import encode_jpeg

CAM_HEIGHT = 1.65  # metres above the ground

# KITTI odometry cam2 intrinsics at 375 x 1242
FX = 718.856
FY = 718.856
CX = 607.1928
CY = 185.2157


@dataclasses.dataclass(frozen=True)
class Box:
    lo: np.ndarray  # (3,) min corner, cam0 world axes
    hi: np.ndarray  # (3,) max corner
    kind: str  # "building" | "car"
    base_color: np.ndarray  # (3,)


SEMANTIC_CLASSES = ["road", "building", "car", "sky"]
SEMANTIC_COLORS = np.array([[128, 64, 128], [70, 70, 70], [0, 0, 142], [70, 130, 180]],
                           np.uint8)


def make_scene(seed: int = 0, length: float = 120.0) -> list[Box]:
    """Buildings lining a straight road, and parked cars."""
    rng = np.random.default_rng(seed)
    boxes: list[Box] = []
    for side in (-1.0, 1.0):
        z = 0.0
        while z < length:
            depth = rng.uniform(8.0, 16.0)
            height = rng.uniform(6.0, 14.0)
            x0 = side * rng.uniform(7.0, 9.0)
            width = rng.uniform(3.0, 6.0)
            lo = np.array([min(x0, x0 + side * width), CAM_HEIGHT - height, z], np.float64)
            hi = np.array([max(x0, x0 + side * width), CAM_HEIGHT, z + depth], np.float64)
            boxes.append(Box(lo, hi, "building", rng.uniform(0.35, 0.75, 3)))
            z += depth + rng.uniform(0.0, 3.0)
    for i in range(10):
        side = -1.0 if i % 2 == 0 else 1.0
        z = 6.0 + 11.0 * i
        x0 = side * 5.2
        lo = np.array([min(x0, x0 + side * 1.8), CAM_HEIGHT - 1.5, z], np.float64)
        hi = np.array([max(x0, x0 + side * 1.8), CAM_HEIGHT, z + 4.2], np.float64)
        col = np.array([[0.7, 0.1, 0.1], [0.1, 0.2, 0.7], [0.8, 0.8, 0.8], [0.1, 0.5, 0.2],
                        [0.9, 0.6, 0.1]][i % 5], np.float64)
        boxes.append(Box(lo, hi, "car", col))
    return boxes


def make_poses(n_frames: int, step: float = 0.8) -> np.ndarray:
    """(N, 3, 4) cam0 -> world poses driving forward along +z with a gentle
    sway and yaw."""
    poses = []
    for i in range(n_frames):
        z = step * i
        x = 0.35 * np.sin(0.05 * z)
        yaw = 0.018 * np.cos(0.05 * z)
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        poses.append(np.concatenate([R, np.array([x, 0.0, z])[:, None]], axis=1))
    return np.stack(poses)


def _road_color(p: np.ndarray) -> np.ndarray:
    """Asphalt with a dashed centre line, edge lines, mottling and
    sidewalks."""
    x, z = p[:, 0], p[:, 2]
    base = 0.22 + 0.05 * np.sin(2.1 * x) * np.sin(1.7 * z) + 0.03 * np.sin(7.3 * x + 3.1 * z)
    col = np.stack([base, base, base], axis=1)
    dash = (np.abs(x) < 0.12) & (np.mod(z, 6.0) < 3.0)
    edge = np.abs(np.abs(x) - 4.6) < 0.12
    col[dash] = [0.85, 0.85, 0.75]
    col[edge] = [0.8, 0.8, 0.8]
    walk = np.abs(x) > 4.9
    g = 0.45 + 0.08 * np.sin(3.0 * x[walk]) * np.sin(3.0 * z[walk])
    col[walk] = np.stack([g, g, g * 0.95], axis=1)
    return col


def _building_color(p: np.ndarray, box: Box) -> np.ndarray:
    """Facade with a grid of dark windows."""
    y, z = p[:, 1], p[:, 2]
    u = z - box.lo[2]
    v = box.hi[1] - y  # height above the ground
    win = (np.mod(u, 2.4) < 1.4) & (np.mod(v, 2.8) > 1.1) & (np.mod(v, 2.8) < 2.3) & (v > 0.8)
    col = np.broadcast_to(box.base_color, (p.shape[0], 3)).copy()
    col *= (0.75 + 0.25 * np.sin(1.3 * u) * np.sin(0.9 * v))[:, None]
    col[win] = [0.08, 0.1, 0.14]
    return col


def _car_color(p: np.ndarray, box: Box) -> np.ndarray:
    col = np.broadcast_to(box.base_color, (p.shape[0], 3)).copy()
    v = box.hi[1] - p[:, 1]
    col[v > 0.9] = [0.15, 0.16, 0.2]  # window band
    col[v < 0.25] *= 0.4  # skirt
    return col


def _sky_color(d: np.ndarray) -> np.ndarray:
    """Gradient by elevation (-y is up)."""
    up = np.clip(-d[:, 1], 0.0, 1.0)
    top = np.array([0.35, 0.55, 0.85])
    hor = np.array([0.78, 0.84, 0.9])
    return hor[None, :] + (top - hor)[None, :] * up[:, None] ** 0.7


def trace(origins: np.ndarray, dirs: np.ndarray, boxes: list[Box], return_ids: bool = False):
    """Nearest-hit trace of unit rays (N, 3) in cam0 world axes. Returns rgb
    (N, 3), the distance along the ray (N,) and semantic ids (N,), and with
    ``return_ids`` the hit box indices (N,) (-1 ground, -2 sky)."""
    n = origins.shape[0]
    best_t = np.full(n, np.inf)
    rgb = _sky_color(dirs)
    sem = np.full(n, SEMANTIC_CLASSES.index("sky"), np.int32)
    ids = np.full(n, -2, np.int32)

    dy = dirs[:, 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_pl = (CAM_HEIGHT - origins[:, 1]) / dy
    hit = (dy > 1e-9) & (t_pl > 1e-6)
    if hit.any():
        best_t[hit] = t_pl[hit]
        rgb[hit] = _road_color(origins[hit] + dirs[hit] * t_pl[hit, None])
        sem[hit] = SEMANTIC_CLASSES.index("road")
        ids[hit] = -1

    inv = np.where(np.abs(dirs) > 1e-12, 1.0 / dirs, np.inf)
    for bi, box in enumerate(boxes):
        t0 = (box.lo[None, :] - origins) * inv
        t1 = (box.hi[None, :] - origins) * inv
        tmin = np.minimum(t0, t1).max(axis=1)
        tmax = np.maximum(t0, t1).min(axis=1)
        hit = (tmax > np.maximum(tmin, 1e-6)) & (tmin < best_t) & (tmin > 1e-6)
        if not hit.any():
            continue
        p = origins[hit] + dirs[hit] * tmin[hit, None]
        best_t[hit] = tmin[hit]
        ids[hit] = bi
        if box.kind == "building":
            rgb[hit] = _building_color(p, box)
            sem[hit] = SEMANTIC_CLASSES.index("building")
        else:
            rgb[hit] = _car_color(p, box)
            sem[hit] = SEMANTIC_CLASSES.index("car")

    depth = np.where(np.isfinite(best_t), best_t, 0.0)
    # distance haze keeps far geometry smooth to learn
    haze = np.clip(depth / 160.0, 0.0, 0.55)[:, None]
    sky = sem == SEMANTIC_CLASSES.index("sky")
    rgb = np.clip(np.where(sky[:, None], rgb, rgb * (1 - haze) + haze * 0.8), 0.0, 1.0)
    if return_ids:
        return rgb, depth, sem, ids
    return rgb, depth, sem


def _pixel_rays(pose: np.ndarray, h: int, w: int, fx: float, fy: float, cx: float, cy: float):
    """Rays of every pixel of a (3, 4) cam0 -> world pose: origins (HW, 3),
    unit world directions (HW, 3), the camera-space direction norms (HW, 1)
    and the pixel xs and ys (HW,)."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    d_cam = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], axis=-1).reshape(-1, 3)
    d_world = d_cam @ pose[:3, :3].T
    norm = np.linalg.norm(d_world, axis=1, keepdims=True)
    o = np.broadcast_to(pose[:3, 3], d_world.shape)
    return o, d_world / norm, norm, xs.reshape(-1), ys.reshape(-1)


def render_frame(pose: np.ndarray, boxes: list[Box], h: int, w: int, fx: float = FX,
                 fy: float = FY, cx: float | None = None, cy: float | None = None):
    """One frame of the static scene from a (3, 4) cam0 -> world pose: (rgb
    (H, W, 3), z-depth (H, W) f32, semantic ids (H, W) int32)."""
    cx = CX * w / 1242.0 if cx is None else cx
    cy = CY * h / 375.0 if cy is None else cy
    o, dirs, norm, _, _ = _pixel_rays(pose, h, w, fx, fy, cx, cy)
    rgb, t_ray, sem = trace(o, dirs, boxes)
    # the camera-space direction has z = 1: z-depth = ray distance / |d_cam|
    return (rgb.reshape(h, w, 3), (t_ray / norm[:, 0]).reshape(h, w).astype(np.float32),
            sem.reshape(h, w).astype(np.int32))


def _project_into(pose_b: np.ndarray, pts: np.ndarray, fx: float, fy: float, cx: float,
                  cy: float):
    """World points projected into a (3, 4) cam0 -> world frame b (x right, y
    down, z forward): (u (N,), v (N,), z (N,))."""
    cam_b = (pts - pose_b[:3, 3]) @ pose_b[:3, :3]  # R_b^T (p - t_b), row by row
    z = cam_b[:, 2]
    zs = np.where(np.abs(z) < 1e-6, 1e-6, z)
    return fx * cam_b[:, 0] / zs + cx, fy * cam_b[:, 1] / zs + cy, z


def _flow_of(pts, sem, xs_f, ys_f, pose_b, h, w, fx, fy, cx, cy):
    """Flow of traced points into frame b: (flow (H, W, 2) f32, valid (H, W)
    bool). Valid are hit pixels (not sky: their depth is undefined) that land
    in front of camera b."""
    u1, v1, z = _project_into(pose_b, pts, fx, fy, cx, cy)
    valid = (sem != SEMANTIC_CLASSES.index("sky")) & (z > 0.1)
    flow = np.where(valid[:, None], np.stack([u1 - xs_f, v1 - ys_f], -1), 0.0)
    return flow.reshape(h, w, 2).astype(np.float32), valid.reshape(h, w)


def render_flow(pose_a: np.ndarray, pose_b: np.ndarray, boxes: list[Box], h: int, w: int,
                fx: float, fy: float, cx: float, cy: float):
    """Exact forward optical flow from frame a to frame b of the static
    scene (camera motion only): frame a traced, each hit point projected
    into frame b. Returns (flow (H, W, 2) f32, valid (H, W) bool)."""
    o, dirs, _, xs_f, ys_f = _pixel_rays(pose_a, h, w, fx, fy, cx, cy)
    _, t_ray, sem = trace(o, dirs, boxes)
    return _flow_of(o + dirs * t_ray[:, None], sem, xs_f, ys_f, pose_b, h, w, fx, fy, cx, cy)


def _write_calib(out: Path, fx: float, fy: float, cx: float, cy: float) -> None:
    p2 = np.zeros((3, 4))
    p2[0, 0], p2[1, 1], p2[0, 2], p2[1, 2], p2[2, 2] = fx, fy, cx, cy, 1.0
    lines = [name + ": " + " ".join(f"{v:.12e}" for v in p2.reshape(-1))
             for name in ("P0", "P1", "P2", "P3")]
    (out / "calib.txt").write_text("\n".join(lines) + "\n")


def _write_poses(out: Path, seq: str, poses: np.ndarray) -> None:
    with open(out / f"{seq}.txt", "w") as f:
        for p in poses:
            f.write(" ".join(f"{v:.12e}" for v in p.reshape(-1)) + "\n")


def _write_semantics_list(out: Path) -> None:
    rows = ["Category,R,G,B"] + [f"{c},{r},{g},{b}"
                                 for c, (r, g, b) in zip(SEMANTIC_CLASSES, SEMANTIC_COLORS)]
    (out / "semantics_list.txt").write_text("\n".join(rows) + "\n")


def _save_flow(path: Path, flow: np.ndarray, valid: np.ndarray) -> None:
    np.save(path, np.concatenate([flow, valid[..., None].astype(np.float32)], -1))


def write_dataset(out_dir: str | Path, n_frames: int = 40, h: int = 375, w: int = 1242,
                  seed: int = 0, fx: float | None = None, fy: float | None = None,
                  step: float = 0.8, write_flow: bool = False) -> Path:
    """Write the static scene in the KITTI layout (module docstring): frames,
    z-depth, colour semantics and all-white masks, and with ``write_flow``
    the forward flow t -> t + 1. Returns out_dir."""
    out = Path(out_dir)
    seq = "00"
    for d in (seq, "depth", "sem", "mask"):
        (out / d).mkdir(parents=True, exist_ok=True)
    sx, sy = w / 1242.0, h / 375.0
    fx = FX * sx if fx is None else fx
    fy = FY * sy if fy is None else fy
    cx, cy = CX * sx, CY * sy
    _write_calib(out, fx, fy, cx, cy)
    boxes = make_scene(seed=seed, length=n_frames * step + 90.0)
    poses = make_poses(n_frames, step=step)
    _write_poses(out, seq, poses)
    for i, pose in enumerate(poses):
        rgb, depth, sem = render_frame(pose, boxes, h, w, fx, fy, cx, cy)
        (out / seq / f"{i:06}.png").write_bytes(encode_png_u8((rgb * 255).astype(np.uint8)))
        np.save(out / "depth" / f"{i:06}.npy", depth)
        (out / "sem" / f"{i:06}.png").write_bytes(encode_png_u8(SEMANTIC_COLORS[sem]))
        (out / "mask" / f"{i:06}.png").write_bytes(encode_png_u8(np.full((h, w), 255, np.uint8)))
        if write_flow and i + 1 < len(poses):
            (out / "flow_fwd").mkdir(exist_ok=True)
            _save_flow(out / "flow_fwd" / f"{i:06}.npy",
                       *render_flow(pose, poses[i + 1], boxes, h, w, fx, fy, cx, cy))
    _write_semantics_list(out)
    return out


@dataclasses.dataclass(frozen=True)
class Mover:
    """A box moving at a constant velocity (metres a frame)."""

    box: Box
    velocity: np.ndarray  # (3,), cam0 world axes


def make_movers() -> list[Mover]:
    """Two moving cars: one crossing the road, one oncoming."""
    crossing = Box(lo=np.array([-6.5, CAM_HEIGHT - 1.6, 19.0]),
                   hi=np.array([-2.5, CAM_HEIGHT, 21.0]), kind="car",
                   base_color=np.array([0.85, 0.2, 0.1]))
    oncoming = Box(lo=np.array([-3.4, CAM_HEIGHT - 1.5, 42.0]),
                   hi=np.array([-1.6, CAM_HEIGHT, 46.2]), kind="car",
                   base_color=np.array([0.1, 0.3, 0.8]))
    return [Mover(crossing, np.array([0.9, 0.0, 0.0])),
            Mover(oncoming, np.array([0.0, 0.0, -1.6]))]


def boxes_at(static: list[Box], movers: list[Mover], frame: float) -> list[Box]:
    """The scene's boxes at a frame time, the movers first (trace indices
    0 .. len(movers) - 1)."""
    moved = [Box(m.box.lo + m.velocity * frame, m.box.hi + m.velocity * frame, m.box.kind,
                 m.box.base_color) for m in movers]
    return moved + list(static)


def _dynamic_trace(pose, static, movers, frame, h, w, fx, fy, cx, cy):
    """The trace of one frame with the movers at their positions of
    ``frame``: (origins, unit directions, |d_cam| norms, pixel xs, ys, rgb,
    ray distances, semantic ids, box ids)."""
    o, dirs, norm, xs_f, ys_f = _pixel_rays(pose, h, w, fx, fy, cx, cy)
    rgb, t_ray, sem, ids = trace(o, dirs, boxes_at(static, movers, frame), return_ids=True)
    return o, dirs, norm, xs_f, ys_f, rgb, t_ray, sem, ids


def _dynamic_flow_of(traced, movers, dt, pose_b, h, w, fx, fy, cx, cy):
    """Flow of a dynamic trace into frame b, ``dt`` frames later: points on a
    mover travel with it before the projection."""
    o, dirs, _, xs_f, ys_f, _, t_ray, sem, ids = traced
    pts = o + dirs * t_ray[:, None]
    for mi, m in enumerate(movers):
        on = ids == mi
        if on.any():
            pts[on] += m.velocity * dt
    return _flow_of(pts, sem, xs_f, ys_f, pose_b, h, w, fx, fy, cx, cy)


def render_dynamic_frame(pose, static, movers, frame, h, w, fx, fy, cx, cy):
    """One frame with the movers at their positions of ``frame``: (rgb (H, W,
    3), z-depth (H, W) f32, semantic ids (H, W) int32, moving mask (H, W)
    bool)."""
    _, _, norm, _, _, rgb, t_ray, sem, ids = _dynamic_trace(pose, static, movers, frame, h, w,
                                                            fx, fy, cx, cy)
    dyn = (ids >= 0) & (ids < len(movers))
    # the camera-space direction has z = 1: z-depth = ray distance / |d_cam|
    return (rgb.reshape(h, w, 3), (t_ray / norm[:, 0]).reshape(h, w).astype(np.float32),
            sem.reshape(h, w).astype(np.int32), dyn.reshape(h, w))


def render_dynamic_flow(pose_a, pose_b, static, movers, frame_a, frame_b, h, w, fx, fy, cx, cy):
    """Exact forward optical flow of the dynamic scene from frame a to frame
    b: (flow (H, W, 2) f32, valid (H, W) bool, moving mask (H, W) bool)."""
    traced = _dynamic_trace(pose_a, static, movers, frame_a, h, w, fx, fy, cx, cy)
    flow, valid = _dynamic_flow_of(traced, movers, frame_b - frame_a, pose_b, h, w,
                                   fx, fy, cx, cy)
    ids = traced[-1]
    return flow, valid, ((ids >= 0) & (ids < len(movers))).reshape(h, w)


def write_dynamic_dataset(out_dir: str | Path, n_frames: int = 24, h: int = 188, w: int = 621,
                          seed: int = 0, step: float = 0.8) -> Path:
    """Write the dynamic scene in the KITTI layout (module docstring):
    frames, z-depth, colour semantics, static masks and the forward flow of
    every frame but the last. Each frame is traced once: its flow comes from
    the same trace (``render_dynamic_flow`` traces it again and gives the
    same arrays). Returns out_dir."""
    out = Path(out_dir)
    seq = "00"
    for d in (seq, "depth", "sem", "mask", "flow_fwd"):
        (out / d).mkdir(parents=True, exist_ok=True)

    sx, sy = w / 1242.0, h / 375.0
    fx, fy, cx, cy = FX * sx, FY * sy, CX * sx, CY * sy
    _write_calib(out, fx, fy, cx, cy)
    static = make_scene(seed=seed, length=n_frames * step + 90.0)
    movers = make_movers()
    poses = make_poses(n_frames, step=step)
    _write_poses(out, seq, poses)

    for i, pose in enumerate(poses):
        traced = _dynamic_trace(pose, static, movers, i, h, w, fx, fy, cx, cy)
        _, _, norm, _, _, rgb, t_ray, sem, ids = traced
        dyn = ((ids >= 0) & (ids < len(movers))).reshape(h, w)
        rgb = rgb.reshape(h, w, 3)
        (out / seq / f"{i:06}.png").write_bytes(encode_png_u8((rgb * 255).astype(np.uint8)))
        np.save(out / "depth" / f"{i:06}.npy",
                (t_ray / norm[:, 0]).reshape(h, w).astype(np.float32))
        # colour maps: the datamanager maps colours back to class ids
        (out / "sem" / f"{i:06}.png").write_bytes(
            encode_png_u8(SEMANTIC_COLORS[sem.reshape(h, w)]))
        (out / "mask" / f"{i:06}.png").write_bytes(
            encode_png_u8(((~dyn) * 255).astype(np.uint8)))
        if i + 1 < len(poses):
            _save_flow(out / "flow_fwd" / f"{i:06}.npy",
                       *_dynamic_flow_of(traced, movers, 1, poses[i + 1], h, w, fx, fy, cx, cy))
    _write_semantics_list(out)
    return out


def write_vkitti_dataset(out_dir: str | Path, n_frames: int = 20, h: int = 188, w: int = 621,
                         seed: int = 0, step: float = 0.8) -> Path:
    """Write the static scene in the Virtual KITTI 2 layout (module
    docstring). Returns out_dir."""
    out = Path(out_dir)
    rgb_dir = out / "frames" / "rgb" / "Camera_0"
    depth_dir = out / "frames" / "depth" / "Camera_0"
    rgb_dir.mkdir(parents=True, exist_ok=True)
    depth_dir.mkdir(parents=True, exist_ok=True)

    sx, sy = w / 1242.0, h / 375.0
    fx, fy, cx, cy = FX * sx, FY * sy, CX * sx, CY * sy
    boxes = make_scene(seed=seed, length=n_frames * step + 90.0)
    intr_rows = ["frame cameraID K[0,0] K[1,1] K[0,2] K[1,2]"]
    extr_rows = ["frame cameraID r1,1 r1,2 r1,3 t1 r2,1 r2,2 r2,3 t2 "
                 "r3,1 r3,2 r3,3 t3 0 0 0 1"]
    for i, pose in enumerate(make_poses(n_frames, step=step)):
        rgb, depth, _ = render_frame(pose, boxes, h, w, fx, fy, cx, cy)
        (rgb_dir / f"rgb_{i:05d}.jpg").write_bytes(
            encode_jpeg((rgb * 255).astype(np.uint8), quality=97))
        cm16 = np.clip(depth * 100.0, 0, 65535).astype(np.uint16)
        (depth_dir / f"depth_{i:05d}.png").write_bytes(encode_png_u16(cm16))
        intr_rows.append(f"{i} 0 {fx:.6f} {fy:.6f} {cx:.6f} {cy:.6f}")
        P4 = np.eye(4)
        P4[:3] = pose
        extr_rows.append(f"{i} 0 " + " ".join(f"{v:.9e}" for v in np.linalg.inv(P4).reshape(-1)))
    (out / "intrinsic.txt").write_text("\n".join(intr_rows) + "\n")
    (out / "extrinsic.txt").write_text("\n".join(extr_rows) + "\n")
    return out
