"""Image feature store: in memory, or packed once from zarr groups.

Copy of ``vqa_project_tpu/data/datasets.py``'s ``FeatureStore`` and its
file helpers: region features, size-normalized xyxy boxes and the
image-id -> row map. ``FeatureStore.from_zarr`` reads the reference's
artifacts (a features group and a boxes group, one array per image, and
``*_image_size.csv``) and packs them once into two ``.npy`` memmaps under
``<dirname(feat_path)>/_tpu_cache/packed_<path_tag>_<fp_tag>``, the
names and layout the JAX package uses, so a store packed by either
package is reused by the other. ``fp_tag`` fingerprints the inputs, so a
store regenerated in place packs anew and its superseded packs are
removed.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from vqa_project_tpu_torch.data import zarr_store


def write_sizes_csv(path: str, sizes: Dict[str, Sequence[float]]) -> None:
    """Write the ``*_image_size.csv`` artifact: columns are image ids,
    row 0 the width, row 1 the height."""
    ids = list(sizes.keys())
    with open(path, "w") as f:
        f.write("," + ",".join(ids) + "\n")
        f.write("0," + ",".join(str(sizes[i][0]) for i in ids) + "\n")
        f.write("1," + ",".join(str(sizes[i][1]) for i in ids) + "\n")


def _read_sizes_csv(path: str) -> Dict[str, np.ndarray]:
    """The inverse of ``write_sizes_csv``: {image id: [w, h] float32}."""
    with open(path, "r") as f:
        header = f.readline().rstrip("\n").split(",")
        row_w = f.readline().rstrip("\n").split(",")
        row_h = f.readline().rstrip("\n").split(",")
    return {iid: np.array([float(w), float(h)], dtype=np.float32)
            for iid, w, h in zip(header[1:], row_w[1:], row_h[1:])}


def _dir_fingerprint(path: str) -> str:
    """Change detector for a zarr group directory or a plain file: every
    member's name, size and mtime plus the stat of its "0.0" chunk (a
    chunk rewritten in place does not touch the directory's mtime)."""
    if not os.path.exists(path):
        return f"missing:{path}"
    st = os.stat(path)
    if os.path.isfile(path):
        return f"f:{st.st_size}:{st.st_mtime_ns}"
    names = sorted(os.listdir(path))
    h = hashlib.md5()
    for name in names:
        p = os.path.join(path, name)
        s = os.stat(p)
        h.update(f"{name}:{s.st_size}:{s.st_mtime_ns};".encode())
        try:
            cs = os.stat(os.path.join(p, "0.0"))
            h.update(f"{cs.st_size}:{cs.st_mtime_ns};".encode())
        except OSError:
            pass
    return f"d:{len(names)}:{h.hexdigest()}"


def pack_paths(feat_path: str, box_path: str, sizes_csv: str, n_obj: int,
               cache_dir: Optional[str] = None):
    """(meta .json, features .npy, boxes .npy) of the pack of these
    inputs, and the glob of every pack of the same store."""
    cache_dir = cache_dir or os.path.join(
        os.path.dirname(feat_path) or ".", "_tpu_cache")
    path_tag = hashlib.sha1(
        f"{os.path.abspath(feat_path)}:{n_obj}".encode()).hexdigest()[:12]
    fp_tag = hashlib.sha1("|".join(
        _dir_fingerprint(p) for p in (feat_path, box_path, sizes_csv)
    ).encode()).hexdigest()[:12]
    base = os.path.join(cache_dir, f"packed_{path_tag}_{fp_tag}")
    return ((base + ".json", base + "_feat.npy", base + "_box.npy"),
            os.path.join(cache_dir, f"packed_{path_tag}_*"))


def region_counts(features, chunk: int = 1024) -> np.ndarray:
    """(N,) int32: for each image of a (N, K, F) table, one past its last
    region row that is not all zero (0 for an image of zero rows), read
    ``chunk`` images at a time. Where an image's zero rows are its last
    ones, as padded detector features are, its first ``count`` rows are
    exactly those whose features do not sum to 0 in absolute value
    (MCAN's padding rule)."""
    n, k = features.shape[:2]
    out = np.zeros((n,), np.int32)
    for i in range(0, n, chunk):
        live = np.abs(np.asarray(features[i:i + chunk],
                                 np.float32)).sum(-1) > 0
        last = k - np.argmax(live[:, ::-1], axis=1)
        out[i:i + len(live)] = np.where(live.any(axis=1), last, 0)
    return out


class FeatureStore:
    """(n_images, K, feat) features + (n_images, K, 4) boxes, by row."""

    def __init__(self, features: np.ndarray, boxes: np.ndarray,
                 id_to_row: Dict[str, int]):
        if features.shape[0] != boxes.shape[0]:
            raise ValueError("features and boxes differ in image count")
        self.features = features
        self.boxes = boxes
        self.id_to_row = id_to_row
        self.n_obj = features.shape[1]
        self.feat_dim = features.shape[2] + 4  # + bbox

    @classmethod
    def from_zarr(cls, feat_path: str, box_path: str, sizes_csv: str,
                  n_obj: int, cache_dir: Optional[str] = None
                  ) -> "FeatureStore":
        """The store of these zarr groups as memmaps, packed on first use:
        rows in the features group's (sorted) order, the first n_obj
        boxes of each image, boxes divided by the image's width and
        height in float32. Non-finite features raise ValueError."""
        (meta_p, feat_p, box_p), pattern = pack_paths(
            feat_path, box_path, sizes_csv, n_obj, cache_dir)
        if all(os.path.exists(p) for p in (meta_p, feat_p, box_p)):
            with open(meta_p) as f:
                meta = json.load(f)
            return cls(np.load(feat_p, mmap_mode="r"),
                       np.load(box_p, mmap_mode="r"), meta["id_to_row"])
        for stale in glob.glob(pattern):  # packs of superseded inputs
            try:
                os.remove(stale)
            except OSError:
                pass

        fgroup = zarr_store.open_group(feat_path)
        bgroup = zarr_store.open_group(box_path)
        sizes = _read_sizes_csv(sizes_csv)
        ids = fgroup.keys()
        if not ids:
            raise ValueError(f"empty feature store: {feat_path}")
        fdim = fgroup[ids[0]].shape[1]
        os.makedirs(os.path.dirname(feat_p), exist_ok=True)
        feats = np.lib.format.open_memmap(
            feat_p, mode="w+", dtype=np.float32,
            shape=(len(ids), n_obj, fdim))
        boxes = np.lib.format.open_memmap(
            box_p, mode="w+", dtype=np.float32, shape=(len(ids), n_obj, 4))
        id_to_row: Dict[str, int] = {}
        for row, iid in enumerate(ids):
            farr = np.asarray(fgroup[iid], dtype=np.float32)
            barr = np.asarray(bgroup[iid], dtype=np.float32)
            if not np.isfinite(farr).all():
                raise ValueError(f"non-finite features for image {iid}")
            k = min(n_obj, farr.shape[0])
            feats[row, :k] = farr[:k]
            wh = sizes[iid]
            b = barr[:k].copy()
            b[:, 0] /= wh[0]
            b[:, 1] /= wh[1]
            b[:, 2] /= wh[0]
            b[:, 3] /= wh[1]
            boxes[row, :k] = b
            id_to_row[iid] = row
        feats.flush()
        boxes.flush()
        with open(meta_p, "w") as f:
            json.dump({"id_to_row": id_to_row}, f)
        return cls(feats, boxes, id_to_row)

    def batch(self, rows: np.ndarray) -> np.ndarray:
        """(len(rows), K, feat_dim) feature||bbox tensor for a batch."""
        f = np.asarray(self.features[rows])
        b = np.asarray(self.boxes[rows])
        return np.concatenate([f, b], axis=-1)
