"""Chunked pixel-stream datamanager for datasets larger than host memory
(the JAX package's ``data/stream.py``, the SUDS-style streaming stack).

Pixel rows are streamed in large chunks (``items_per_chunk``) rather than
every frame held in memory. The next chunk is built on a background
single-worker executor while the current one is consumed (double
buffering); the one worker serialises chunk builds, and each build fans the
frames' asset loads out on a thread pool. The executor's threads touch
NumPy only, never a device. Two fill modes: a sequential sweep over every
supervised pixel of the frames, resuming where the last chunk stopped, or a
uniform random subset (``load_random_subset``). Each row carries
'ray_indices' (image, row, col), 'image', 'mask' and, where configured and
every frame has them, 'depth_image', 'time' / 'video_id', the flow rows
('forward_flow', 'flow_valid', 'fwd_w2c', 'fwd_K', 'pixel_xy'), 'sky' and
'features'. Each pass is reshuffled; with ``num_shards`` a host keeps the
rows where row_id % num_shards == shard_index.

The draws are the JAX package's: the reshuffle from
``default_rng(seed + shard_index)``, the random subset of chunk k from
``default_rng((seed, k))``, so with the same seed the chunks equal the JAX
package's row for row. ``close()`` ends the executor: call it when training
ends, or a pending chunk build holds up the process's exit.

What the trainer reads: ``train_outputs`` / ``eval_outputs`` (the cameras,
with per-frame times and video ids), ``next_train``,
``num_eval_images`` and ``eval_image``.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from nerf_kbs_tpu_torch.cameras.poses import invert_se3, to_homogeneous
from nerf_kbs_tpu_torch.data.image_metadata import ImageMetadata, cameras_np
from nerf_kbs_tpu_torch.data.outputs import DataparserOutputs
from nerf_kbs_tpu_torch.parallel.multihost import host_shard_info


@dataclasses.dataclass
class StreamConfig:
    items_per_chunk: int = 12_800_000
    train_num_rays_per_batch: int = 4096
    load_random_subset: bool = False
    num_asset_workers: int = 16
    seed: int = 0
    shard_index: int = 0
    num_shards: int = 1
    with_depth: bool = True
    with_time: bool = True
    # per-row sky-mask / feature supervision, when every frame has the path
    with_sky: bool = False
    with_features: bool = False
    # per-row flow supervision: the forward flow, the forward neighbour's
    # w2c and intrinsics, the pixel's coordinates
    with_flow: bool = False


def _outputs_of(items: list[ImageMetadata]) -> DataparserOutputs:
    return DataparserOutputs(
        [it.image_path for it in items], cameras_np(items), np.array([[-1.0] * 3, [1.0] * 3]),
        times=np.array([it.time for it in items], np.float32),
        video_ids=np.array([it.video_id for it in items], np.int32),
    )


class ChunkedStreamDataManager:
    """Streams pixel rows from a list of ImageMetadata (see the module
    docstring)."""

    def __init__(self, train_items: list[ImageMetadata], eval_items: list[ImageMetadata],
                 config: Optional[StreamConfig] = None):
        if not train_items:
            raise ValueError("no train items")
        config = StreamConfig() if config is None else config
        self.config = config
        self.train_items = train_items
        self.eval_items = eval_items
        self._rng = np.random.default_rng(config.seed + config.shard_index)
        # one key set for the whole run, decided from every item up front:
        # optional rows only when every frame can give them, so no chunk's
        # batch has keys another lacks
        self._emit_depth = config.with_depth and all(
            it.depth_path is not None for it in train_items)
        self._emit_sky = config.with_sky and all(
            it.sky_mask_path is not None for it in train_items)
        self._emit_features = config.with_features and all(
            it.feature_path is not None for it in train_items)
        self._chunk_counter = 0
        # the sweep's cursor over frames; only the chunk executor moves it
        self._sweep_pos = 0
        self._chunk_executor = ThreadPoolExecutor(max_workers=1)
        self._next_chunk_future = self._chunk_executor.submit(self._build_chunk)
        self._chunk: Optional[dict] = None
        self._cursor = 0
        self.train_outputs = _outputs_of(train_items)
        self.eval_outputs = _outputs_of(eval_items or train_items[:1])
        self.semantics = None

    # ------------------------------------------------------------ chunk build
    def _load_image_rows(self, item_idx: int) -> dict:
        """Every supervised pixel of one frame as flat row arrays."""
        it = self.train_items[item_idx]
        img = it.load_image()
        mask = it.load_mask()
        h, w = img.shape[:2]
        rr, cc = np.nonzero(mask)
        n = len(rr)
        rows = {
            "ray_indices": np.stack([np.full_like(rr, item_idx), rr, cc], -1).astype(np.int32),
            "image": img[rr, cc].astype(np.float32) / 255.0,
        }
        if self._emit_depth:
            rows["depth_image"] = it.load_depth()[rr, cc][:, None].astype(np.float32)
        if self.config.with_time:
            rows["time"] = np.full((n, 1), it.time, np.float32)
            rows["video_id"] = np.full((n, 1), it.video_id, np.int32)
        if self.config.with_flow:
            # every frame gives the flow keys (a chunk keeps only the keys
            # all its frames have, and the last frame has no forward
            # neighbour): a frame without one gives flow_valid = 0 rows
            nbr_idx = it.forward_neighbor_index
            if (it.forward_flow_path is not None and nbr_idx is not None
                    and 0 <= nbr_idx < len(self.train_items)):
                flow, valid = it.load_forward_flow()
                nbr = self.train_items[nbr_idx]
                w2c = invert_se3(to_homogeneous(np.asarray(nbr.c2w)[None]))[0, :3, :4]
                rows["forward_flow"] = flow[rr, cc].astype(np.float32)
                rows["flow_valid"] = valid[rr, cc].astype(np.float32)[:, None]
                rows["fwd_w2c"] = np.tile(w2c[None].astype(np.float32), (n, 1, 1))
                rows["fwd_K"] = np.tile(np.asarray(nbr.intrinsics, np.float32)[None], (n, 1))
            else:
                rows["forward_flow"] = np.zeros((n, 2), np.float32)
                rows["flow_valid"] = np.zeros((n, 1), np.float32)
                rows["fwd_w2c"] = np.tile(np.eye(3, 4, dtype=np.float32)[None], (n, 1, 1))
                rows["fwd_K"] = np.tile(np.asarray(it.intrinsics, np.float32)[None], (n, 1))
            rows["pixel_xy"] = np.stack([cc + 0.5, rr + 0.5], -1).astype(np.float32)
        if self._emit_sky:
            rows["sky"] = it.load_sky_mask()[rr, cc][:, None].astype(np.float32)
        if self._emit_features:
            feats = it.load_features()  # possibly at a reduced resolution
            rows["features"] = feats[(rr * feats.shape[0]) // h,
                                     (cc * feats.shape[1]) // w].astype(np.float32)
        rows["mask"] = np.ones((n, 1), np.float32)
        return rows

    def _build_chunk(self) -> dict:
        cfg = self.config
        n_items = len(self.train_items)
        parts: list[dict] = []
        total = 0
        if cfg.load_random_subset:
            # split the pixel budget multinomially over the frames, then a
            # uniform subset of each frame's pixels. The generator has no
            # shard_index, so every host draws the same subset and the shard
            # filter below splits it
            sub_rng = np.random.default_rng((cfg.seed, self._chunk_counter))
            self._chunk_counter += 1
            counts = sub_rng.multinomial(cfg.items_per_chunk, np.full(n_items, 1.0 / n_items))
            chosen = np.nonzero(counts)[0]
            with ThreadPoolExecutor(cfg.num_asset_workers) as ex:
                for i, rows in zip(chosen, ex.map(self._load_image_rows, chosen)):
                    n = rows["ray_indices"].shape[0]
                    k = min(int(counts[i]), n)
                    if k == 0:
                        continue
                    sel = sub_rng.choice(n, size=k, replace=False)
                    parts.append({key: v[sel] for key, v in rows.items()})
                    total += k
        else:
            # the sweep resumes at its cursor and wraps, at most one pass a
            # chunk
            frames_loaded = 0
            with ThreadPoolExecutor(cfg.num_asset_workers) as ex:
                while total < cfg.items_per_chunk and frames_loaded < n_items:
                    wave = np.arange(self._sweep_pos,
                                     min(self._sweep_pos + cfg.num_asset_workers, n_items))
                    self._sweep_pos = (0 if self._sweep_pos + len(wave) >= n_items
                                       else self._sweep_pos + len(wave))
                    frames_loaded += len(wave)
                    for rows in ex.map(self._load_image_rows, wave):
                        parts.append(rows)
                        total += rows["ray_indices"].shape[0]
        if not parts or total == 0:
            raise ValueError("chunk build produced no supervised pixels")
        keys = set(parts[0])
        for p in parts[1:]:
            keys &= set(p)
        chunk = {k: np.concatenate([p[k] for p in parts], 0) for k in keys}
        # this host's shard, then the reshuffle
        sel = np.arange(cfg.shard_index, chunk["ray_indices"].shape[0], cfg.num_shards)
        sel = sel[self._rng.permutation(len(sel))]
        return {k: v[sel] for k, v in chunk.items()}

    # ---------------------------------------------------------------- train
    def next_train(self, step: int) -> dict:
        """The next ``train_num_rays_per_batch`` rows of the chunk, swapping
        in the next chunk when this one cannot fill a batch (``step`` is not
        read: the stream's order is its own)."""
        b = self.config.train_num_rays_per_batch
        if self._chunk is None or self._cursor + b > self._chunk["ray_indices"].shape[0]:
            self._chunk = self._next_chunk_future.result()
            self._cursor = 0
            self._next_chunk_future = self._chunk_executor.submit(self._build_chunk)
        n = self._chunk["ray_indices"].shape[0]
        if n < b:
            # a chunk smaller than a batch: cycle its rows, then swap
            idx = np.arange(b) % n
            self._cursor = n
            return {k: v[idx] for k, v in self._chunk.items()}
        s = slice(self._cursor, self._cursor + b)
        self._cursor += b
        return {k: v[s] for k, v in self._chunk.items()}

    # ----------------------------------------------------------------- eval
    def all_indices_eval_cameras(self, generate_ring_view: bool = False,
                                 video_ids: Optional[set] = None,
                                 start_frame: Optional[int] = None,
                                 end_frame: Optional[int] = None,
                                 focal_mult: Optional[float] = None,
                                 pos_shift: Optional[np.ndarray] = None,
                                 rank: Optional[int] = None, world: Optional[int] = None):
        """The eval cameras of rank ``rank`` of ``world`` (by default this
        process's, ``parallel.multihost.host_shard_info``): a video-id filter,
        a per-video frame range (groups of 7 cameras for ring views), the
        rank-strided assignment of images, and focal_mult / pos_shift
        overrides. Returns (eval item positions, DataparserOutputs of every
        eval camera with the overrides applied)."""
        items = list(self.eval_items)
        chunk = 7 if generate_ring_view else 1
        positions = [i for i, it in enumerate(items)
                     if video_ids is None or it.video_id in video_ids]
        if start_frame is not None or end_frame is not None:
            filtered, cur_base, cur_vid = [], None, None
            for j, pos in enumerate(positions):
                it = items[pos]
                if cur_vid != it.video_id:
                    cur_vid, cur_base = it.video_id, j
                vidx = j - cur_base
                if ((start_frame is None or start_frame * chunk <= vidx)
                        and (end_frame is None or end_frame * chunk > vidx)):
                    filtered.append(pos)
            positions = filtered
        if rank is None or world is None:
            rank, world = host_shard_info()
        strided = []
        for i in range(rank * chunk, len(positions) - chunk + 1, chunk * world):
            strided.extend(positions[i:i + chunk])

        out = _outputs_of(self.eval_items)
        cams = out.cameras_np
        if focal_mult is not None:
            cams["fx"] = cams["fx"] * np.float32(focal_mult)
            cams["fy"] = cams["fy"] * np.float32(focal_mult)
        if pos_shift is not None:
            scale = float(self.eval_items[0].pose_scale_factor) or 1.0
            cams["c2w"][..., 3] += np.asarray(pos_shift, np.float32) / scale
        return strided, out

    def num_eval_images(self) -> int:
        return len(self.eval_items)

    def eval_image(self, idx: int) -> dict:
        it = self.eval_items[idx]
        out = {"image": it.load_image().astype(np.float32) / 255.0}
        d = it.load_depth()
        if d is not None:
            out["depth_image"] = d[..., None]
        out["mask"] = it.load_mask()[..., None].astype(np.float32)
        return out

    def close(self) -> None:
        self._chunk_executor.shutdown(wait=False, cancel_futures=True)
