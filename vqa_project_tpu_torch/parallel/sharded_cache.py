"""The feature table split on its image axis over the ranks.

Counterpart of ``vqa_project_tpu/parallel/sharded_cache.py``. The VQA v2
table (123,287 images x 36 x 2048, 18.2 GB in bf16) exceeds the default
per-card budget; split over 4 cards it is 4.55 GB a card. Rank r holds
the rows ``[r * S, (r + 1) * S)`` (S = ceil(N / world), the last shard
zero-padded) and gathers only its own: the Batcher's locality mode
(``Batcher(partitions=cache.partitions()[table.image_row],
n_partitions=world)``) builds every global batch so that the i-th equal
slice holds only rank i's images, so the gather needs no collective.

Each rank's image gather is the single-card one (``gather_image_rows``,
one launch a step) on its shard, fed ``rows - r * S``: the loop
subtracts on the host while it takes the rank's rows of the index batch
(``local_rows``). The gather clamps rows to the shard on both sides, as
JAX's ``jnp.clip`` does: a padded (mask 0) row of a locality batch may
name a foreign image, and it reads a finite row of this shard instead,
which the masked loss then weighs 0.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from vqa_project_tpu_torch.config import device_guard, torch_dtype
from vqa_project_tpu_torch.ops.gather_rows import gather_image_rows

# images per host chunk while a shard is uploaded
_UPLOAD_ROWS = 1024


def _upload_rows(table, lo: int, hi: int, out: torch.Tensor) -> None:
    """``table[lo:hi]`` into ``out[:hi - lo]``, sent in f32 chunks and
    cast on the device."""
    for i in range(lo, hi, _UPLOAD_ROWS):
        j = min(i + _UPLOAD_ROWS, hi)
        chunk = np.array(table[i:j], dtype=np.float32, copy=True)
        out[i - lo:j - lo].copy_(torch.from_numpy(chunk).to(out.device))


class ShardedFeatureCache:
    """This rank's shard of the features (S, K, F) in the cache dtype and
    of the boxes (S, K, 4) f32."""

    def __init__(self, features: torch.Tensor, boxes: torch.Tensor,
                 rank: int, world: int, shard_size: int, n_images: int):
        self.features = features
        self.boxes = boxes
        self.rank = rank
        self.world = world
        self.shard_size = shard_size   # images per rank
        self.n_images = n_images       # the table's true row count

    @classmethod
    def build(cls, store, mesh,
              dtype: torch.dtype = torch.float32) -> "ShardedFeatureCache":
        """Upload rank ``mesh.rank``'s rows of ``store`` (a FeatureStore:
        ``features`` (N, K, F) and ``boxes`` (N, K, 4), in memory or
        memmapped) to ``mesh.device``, the features in ``dtype``; no rank
        reads another's rows."""
        n = int(store.features.shape[0])
        shard = -(-n // mesh.world)
        lo = min(mesh.rank * shard, n)
        hi = min(lo + shard, n)
        feats = torch.zeros((shard,) + tuple(store.features.shape[1:]),
                            dtype=dtype, device=mesh.device)
        boxes = torch.zeros((shard,) + tuple(store.boxes.shape[1:]),
                            dtype=torch.float32, device=mesh.device)
        _upload_rows(store.features, lo, hi, feats)
        _upload_rows(store.boxes, lo, hi, boxes)
        return cls(feats, boxes, mesh.rank, mesh.world, shard, n)

    def partitions(self) -> np.ndarray:
        """The rank that owns each (true) image row; feed
        ``partitions()[table.image_row]`` to the Batcher."""
        return (np.arange(self.n_images) // self.shard_size).astype(np.int32)

    def local_rows(self, rows: np.ndarray) -> np.ndarray:
        """Global image rows as rows of this rank's shard (int32; rows of
        other shards fall outside it and are clamped by the gather)."""
        return (np.asarray(rows, np.int64)
                - self.rank * self.shard_size).astype(np.int32)

    def gather_fn(self, compute_dtype: str,
                  merged_block: bool = False) -> Callable:
        """``local rows (B,) int32 -> NodeImage`` from this shard, one
        launch of ``gather_image_rows`` (``train.steps.make_image_fn``'s
        image function on the shard)."""
        node_dtype = torch_dtype(compute_dtype)
        features, boxes = self.features, self.boxes

        def image_fn(rows):
            with device_guard(rows.device):
                return gather_image_rows(features, boxes, rows, None,
                                         node_dtype, padded=merged_block)

        image_fn.feature_cache = self   # train_step's bf16-reduce check
        return image_fn
