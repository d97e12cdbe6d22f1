"""The device feature tables: the formats a model's input is gathered
from, and how each is built, gathered and batched.

Each model class names the table its input needs (``feature_cache``):
the conditioned-graph model a ``FeatureCache``, MCAN a ``RegionCache``.
Every format answers the same questions, so that the loop and the step
never ask which one they hold:

- ``build(store, train_cfg, compute_dtype, device, mesh)`` (a
  classmethod): the table of a ``data.store.FeatureStore`` on the card
  when it fits the per-card budget ``train_cfg.device_cache_bytes``,
  else None (host mode: dense batches from the host);
- ``gather_fn(compute_dtype, merged_block)``: ``rows (B,) int32 -> the
  model's image``, one launch of ``ops.gather_rows``;
- ``batcher_kwargs(ds, mesh)``: what the ``data.loader.Batcher`` must
  know of the table;
- ``local_rows(rows)``: a global batch's image rows as rows of this
  rank's table;
- ``bf16_reduce``: whether the bf16 gradient all-reduce may run over it.

``parallel.ShardedFeatureCache`` (the table split over the ranks, which
``FeatureCache.build`` picks where only a share fits) answers the last
four too.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from vqa_project_tpu_torch.config import device_guard, torch_dtype
from vqa_project_tpu_torch.data.store import region_counts
from vqa_project_tpu_torch.ops.gather_rows import (gather_image_rows,
                                                   gather_region_rows)
from vqa_project_tpu_torch.ops.quant import quantize_feature_table
from vqa_project_tpu_torch.parallel.sharded_cache import ShardedFeatureCache

# images per host chunk while a table is uploaded (~300 MB of f32 at the
# VQA v2 widths)
_UPLOAD_ROWS = 1024


def _upload(table: np.ndarray, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """``table`` on ``device`` in ``dtype``, sent in f32 chunks and cast
    there, so no full-size host copy in the cache dtype is made."""
    out = torch.empty(table.shape, dtype=dtype, device=device)
    for i in range(0, table.shape[0], _UPLOAD_ROWS):
        chunk = np.ascontiguousarray(table[i:i + _UPLOAD_ROWS], np.float32)
        if not chunk.flags.writeable:   # a packed store's read-only memmap
            chunk = chunk.copy()
        out[i:i + len(chunk)].copy_(torch.from_numpy(chunk).to(device))
    return out


def _cache_dtype(train_cfg, compute_dtype: Optional[str]) -> str:
    """``train_cfg.feature_cache_dtype``, "auto" read as the compute
    dtype."""
    name = train_cfg.feature_cache_dtype
    return (compute_dtype or "float32") if name == "auto" else name


def _node_fn(features, boxes, scales, compute_dtype: str,
             merged_block: bool) -> Callable:
    """``rows -> NodeImage``: one launch of ``gather_image_rows`` writes
    the node rows feat||bbox in ``compute_dtype`` (int8 rows dequantized
    by ``scales`` there; rows padded for the merged block when
    ``merged_block``) and the f32 boxes."""
    node_dtype = torch_dtype(compute_dtype)

    def image_fn(rows):
        with device_guard(rows.device):
            return gather_image_rows(features, boxes, rows, scales,
                                     node_dtype, padded=merged_block)

    return image_fn


class FeatureCache(NamedTuple):
    """The conditioned-graph model's table, replicated on every rank:
    the features (N, K, F) in the cache dtype and the boxes (N, K, 4)
    f32."""

    features: torch.Tensor
    boxes: torch.Tensor

    bf16_reduce = True

    @classmethod
    def build(cls, store, train_cfg, compute_dtype: Optional[str],
              device: torch.device, mesh=None):
        """By the per-card budget, in this order: a table that fits in
        the cache dtype (``feature_cache_dtype``; "auto" means the compute
        dtype) becomes this pair; "int8" becomes a
        ``QuantizedFeatureCache`` (replicated only), or the compute dtype
        when even int8 does not fit; a table that fits only divided over
        the mesh's data ranks becomes a ``ShardedFeatureCache`` (rank r
        uploads only its rows); else None. On a (data, model) mesh a
        table over the budget streams from the host, as in JAX: the
        sharded cache is the 1-D mesh's."""
        name = _cache_dtype(train_cfg, compute_dtype)
        if name == "int8":
            qc = QuantizedFeatureCache.build(store, train_cfg, compute_dtype,
                                             device, mesh)
            if qc is not None:
                return qc
            name = compute_dtype or "float32"
        dtype = torch_dtype(name)
        itemsize = torch.empty((), dtype=dtype).element_size()
        nbytes = store.features.size * itemsize + store.boxes.nbytes
        budget = train_cfg.device_cache_bytes
        if nbytes <= budget:
            return cls(_upload(store.features, dtype, device),
                       _upload(store.boxes, torch.float32, device))
        if mesh is not None and mesh.tp > 1:
            print(f"feature table {nbytes / 1e9:.1f} GB exceeds device "
                  "cache budget and mesh has a model axis; streaming from "
                  "host (sharded cache is 1-D-mesh only)", flush=True)
            return None
        world = 1 if mesh is None else mesh.data_world
        if world > 1 and nbytes / world <= budget:
            print(f"feature table {nbytes / 1e9:.1f} GB: sharding across "
                  f"{world} ranks ({nbytes / world / 1e9:.1f} GB/rank)",
                  flush=True)
            return ShardedFeatureCache.build(store, mesh, dtype)
        print(f"feature table {nbytes / 1e9:.1f} GB exceeds device cache "
              "budget; streaming features from host", flush=True)
        return None

    def gather_fn(self, compute_dtype: str,
                  merged_block: bool = False) -> Callable:
        """``rows -> NodeImage`` (``_node_fn``)."""
        return _node_fn(self.features, self.boxes, None, compute_dtype,
                        merged_block)

    def batcher_kwargs(self, ds, mesh) -> dict:
        return {}

    def local_rows(self, rows: np.ndarray) -> np.ndarray:
        return rows


class QuantizedFeatureCache(NamedTuple):
    """int8 device feature table with per-box dequantization scales
    (``ops.quant.quantize_feature_table``): a quarter of the f32 table's
    memory, half of bf16's. The gather dequantizes the rows to
    ``out_dtype``, which must be the model's compute dtype; the model is
    unchanged."""

    features: torch.Tensor   # (N, K, F) int8
    scales: torch.Tensor     # (N, K) float32
    boxes: torch.Tensor      # (N, K, 4) float32
    out_dtype: str           # dequantization target

    bf16_reduce = True

    @classmethod
    def build(cls, store, train_cfg, compute_dtype: Optional[str],
              device: torch.device, mesh=None):
        """The int8 table, replicated, or None when even int8 exceeds the
        budget. Quantized on the host one chunk at a time."""
        n, k, f = store.features.shape
        nbytes = n * k * f + n * k * 4 + store.boxes.nbytes
        if nbytes > train_cfg.device_cache_bytes:
            print(f"int8 feature table {nbytes / 1e9:.1f} GB still exceeds "
                  "the device cache budget; using the host mode at the "
                  "compute dtype", flush=True)
            return None
        q = torch.empty((n, k, f), dtype=torch.int8, device=device)
        scales = torch.empty((n, k), dtype=torch.float32, device=device)
        for i in range(0, n, _UPLOAD_ROWS):
            qc, sc = quantize_feature_table(store.features[i:i + _UPLOAD_ROWS])
            q[i:i + len(qc)].copy_(torch.from_numpy(qc).to(device))
            scales[i:i + len(sc)].copy_(torch.from_numpy(sc).to(device))
        boxes = _upload(store.boxes, torch.float32, device)
        return cls(features=q, scales=scales, boxes=boxes,
                   out_dtype=compute_dtype or "float32")

    def gather_fn(self, compute_dtype: str,
                  merged_block: bool = False) -> Callable:
        """``rows -> NodeImage``, dequantized to ``out_dtype``, which must
        be ``compute_dtype``."""
        if torch_dtype(self.out_dtype) != torch_dtype(compute_dtype):
            raise ValueError(f"the int8 cache dequantizes to "
                             f"{self.out_dtype}, the model computes in "
                             f"{compute_dtype}")
        return _node_fn(self.features, self.boxes, self.scales,
                        compute_dtype, merged_block)

    def batcher_kwargs(self, ds, mesh) -> dict:
        return {}

    def local_rows(self, rows: np.ndarray) -> np.ndarray:
        return rows


class RegionCache(NamedTuple):
    """MCAN's device feature table: the region rows (N, K, F) in the
    cache dtype, and each image's count of live regions (N,) int32, its
    rows past the count zero (``data.store.region_counts``)."""

    features: torch.Tensor
    counts: torch.Tensor

    bf16_reduce = True

    @classmethod
    def build(cls, store, train_cfg, compute_dtype: Optional[str],
              device: torch.device, mesh=None):
        """The features and their counts on every rank when they fit the
        budget, else None. The table has no int8 form: an int8 cache
        dtype keeps the compute dtype."""
        name = _cache_dtype(train_cfg, compute_dtype)
        if name == "int8":
            name = compute_dtype or "float32"
        dtype = torch_dtype(name)
        itemsize = torch.empty((), dtype=dtype).element_size()
        n_images = store.features.shape[0]
        nbytes = store.features.size * itemsize + n_images * 4
        if nbytes > train_cfg.device_cache_bytes:
            print(f"region table {nbytes / 1e9:.1f} GB exceeds device cache "
                  "budget; streaming features from host", flush=True)
            return None
        counts = region_counts(store.features, _UPLOAD_ROWS)
        return cls(_upload(store.features, dtype, device),
                   torch.from_numpy(counts).to(device))

    def gather_fn(self, compute_dtype: str,
                  merged_block: bool = False) -> Callable:
        """``rows -> RegionImage``: the rows as the table holds them, by
        one launch of ``gather_region_rows``, with their region
        counts."""
        features, counts = self

        def region_fn(rows):
            with device_guard(rows.device):
                return gather_region_rows(features, counts, rows)

        return region_fn

    def batcher_kwargs(self, ds, mesh) -> dict:
        """The images' region counts, from which each batch counts its
        padded rows."""
        return {"region_counts": self.counts.cpu().numpy()}

    def local_rows(self, rows: np.ndarray) -> np.ndarray:
        return rows


def as_feature_cache(cache):
    """``cache`` as one of the formats: a bare (features, boxes) tuple
    becomes a ``FeatureCache``; None (host mode) and the formats are
    returned as they are."""
    return FeatureCache(*cache) if type(cache) is tuple else cache
