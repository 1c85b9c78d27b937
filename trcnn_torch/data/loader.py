"""Batching, prefetching host loader: the port's copy of
``trcnn/data/loader.py`` (numpy and threads; no JAX).

Fixed-shape batches of padded canvases, grouped by orientation bucket (one
canvas shape per batch); per-example decode and resize on a thread pool
(the port's resize is numpy, which releases the GIL) with a bounded
in-flight window consumed in submission order, so the stream is
deterministic; a background thread keeps ``prefetch`` batches ready, and
an error there is raised in the consumer, not taken for the end of the
data.  Multi-process sharding (``shard_id``/``num_shards``) is numpy only:
every process runs the same seeded schedule and keeps its slice of each
global batch.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, NamedTuple, Tuple

import numpy as np
import torch

from trcnn_torch.config import ImageConfig
from trcnn_torch.data.preprocess import canvas_shape, preprocess_image, scale_gt_boxes


class Batch(NamedTuple):
    images: np.ndarray     # (B, pad_h, pad_w, 3) float32 minus the means, or uint8
    im_info: np.ndarray    # (B, 3) (scaled_h, scaled_w, scale)
    gt_boxes: np.ndarray   # (B, G, 4) float32 canvas coordinates
    gt_labels: np.ndarray  # (B, G) int32
    gt_valid: np.ndarray   # (B, G) bool
    ids: tuple             # (B,) example ids (host-only metadata)


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``.  To the card it goes from a pinned copy,
    asynchronously (a copy from pageable memory would wait for the
    device); PyTorch's pinned allocator keeps the buffer until the copy has
    run."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class DetectionLoader:
    """Shuffled, epoch-repeating, prefetching batch loader.

    dataset: anything with ``__len__``/``get_example`` (the VOCDetection
    protocol).  batch_size: images per batch (per process when sharded).
    max_boxes: the gt capacity G.  augment: horizontal flip with p=0.5 and,
    with ``image_cfg.multiscale_min_sizes``, a shorter side drawn per image
    (the canvas stays fixed).  uint8_images: uint8 canvases without the
    means (the model subtracts them on the device).  shard_id/num_shards:
    multi-process sharding, disjoint and deterministic.
    """

    def __init__(self, dataset, batch_size: int = 1, max_boxes: int = 64,
                 image_cfg: ImageConfig = ImageConfig(), augment: bool = False,
                 shuffle: bool = False, repeat: bool = False, seed: int = 0, prefetch: int = 2,
                 workers: int = 8, uint8_images: bool = False, shard_id: int = 0,
                 num_shards: int = 1):
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        self.image_cfg = image_cfg
        self.augment = augment
        self.shuffle = shuffle
        self.repeat = repeat
        self.seed = seed
        self.prefetch = prefetch
        self.workers = workers
        self.uint8_images = uint8_images
        self.shard_id = shard_id
        self.num_shards = num_shards

    def __len__(self) -> int:
        n = len(range(self.shard_id, len(self.dataset), self.num_shards))
        return (n + self.batch_size - 1) // self.batch_size

    # ---- one example -> padded arrays

    def _load(self, idx: int, rng: np.random.RandomState):
        ex = self.dataset.get_example(idx)
        flip = bool(self.augment and rng.rand() < 0.5)
        min_size = None
        scales = self.image_cfg.multiscale_min_sizes
        if self.augment and scales:
            min_size = int(scales[rng.randint(len(scales))])
        canvas, im_info = preprocess_image(ex["image"], self.image_cfg, flip, min_size=min_size,
                                           as_uint8=self.uint8_images)
        g = self.max_boxes
        boxes = np.zeros((g, 4), np.float32)
        labels = np.zeros((g,), np.int32)
        valid = np.zeros((g,), bool)
        gt = scale_gt_boxes(ex["boxes"], float(im_info[2]), ex["image"].shape[1], flip)
        k = min(len(gt), g)
        if k:
            boxes[:k] = gt[:k]
            labels[:k] = ex["labels"][:k]
            valid[:k] = True
        return canvas, im_info, boxes, labels, valid, ex["id"]

    @staticmethod
    def _make_batch(parts) -> Batch:
        return Batch(*(np.stack([p[i] for p in parts]) for i in range(5)),
                     ids=tuple(p[5] for p in parts))

    # ---- the index schedule

    def _index_stream(self) -> Iterator[int]:
        rng = np.random.RandomState(self.seed)
        while True:
            order = np.arange(len(self.dataset))
            if self.shuffle:
                rng.shuffle(order)
            if self.num_shards > 1:
                yield from self._sharded_epoch(order)
            else:
                yield from order
            if not self.repeat:
                return

    def _sharded_epoch(self, order: np.ndarray) -> Iterator[int]:
        """Every process runs the same schedule: the shuffled order grouped
        into global batches of batch_size * num_shards examples of one
        canvas bucket (the orientation from ``dataset.get_size``, no
        decode), each process keeping its contiguous slice of each global
        batch.  Sharding examples first and bucketing after would let two
        processes' k-th batches differ in shape."""
        if not hasattr(self.dataset, "get_size"):
            raise TypeError(f"sharding (num_shards > 1) needs {type(self.dataset).__name__}"
                            ".get_size(i) -> (h, w) for a globally consistent bucket schedule")
        global_bs = self.batch_size * self.num_shards
        lo = self.shard_id * self.batch_size
        buckets: Dict[Tuple[int, int], list] = {}
        for idx in order:
            key = canvas_shape(*self.dataset.get_size(int(idx)), self.image_cfg)
            bucket = buckets.setdefault(key, [])
            bucket.append(int(idx))
            if len(bucket) == global_bs:
                yield from bucket[lo:lo + self.batch_size]
                buckets[key] = []
        if not self.repeat:
            # partial global buckets, padded by repeating their head so that
            # every process still sees a full local batch of one bucket
            for bucket in buckets.values():
                if bucket:
                    bucket = (bucket * (global_bs // len(bucket) + 1))[:global_bs]
                    yield from bucket[lo:lo + self.batch_size]

    def _batches(self) -> Iterator[Batch]:
        """Fixed-shape batches, examples grouped by canvas bucket; without
        ``repeat``, each partial bucket is flushed at the end, padded by
        repeating its first example.  Each example k of the stream draws
        from its own RandomState (a shared one would race across threads)."""
        pending: Dict[Tuple[int, ...], list] = {}

        def load(idx: int, k: int):
            return self._load(idx, np.random.RandomState(
                (self.seed + 1) * 1000003 + k & 0x7FFFFFFF))

        stream = enumerate(self._index_stream())
        workers = max(self.workers, 1)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            window: list = []

            def submit() -> bool:
                try:
                    k, idx = next(stream)
                except StopIteration:
                    return False
                window.append(pool.submit(load, idx, k))
                return True

            for _ in range(workers * 2):
                if not submit():
                    break
            while window:
                part = window.pop(0).result()
                submit()
                bucket = pending.setdefault(part[0].shape, [])
                bucket.append(part)
                if len(bucket) == self.batch_size:
                    yield self._make_batch(bucket)
                    pending[part[0].shape] = []
        if not self.repeat:
            for bucket in pending.values():
                if bucket:
                    bucket += [bucket[0]] * (self.batch_size - len(bucket))
                    yield self._make_batch(bucket)

    def __iter__(self) -> Iterator[Batch]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list = []

        def worker():
            try:
                for b in self._batches():
                    q.put(b)
            except BaseException as e:     # raised in the consumer: a failed
                err.append(e)              # decode must not look like the end
            finally:
                q.put(sentinel)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise RuntimeError("DetectionLoader worker failed") from err[0]
                return
            yield item
