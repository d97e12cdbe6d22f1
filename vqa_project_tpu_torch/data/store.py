"""In-memory image feature store.

Copy of the in-memory part of ``vqa_project_tpu/data/datasets.py::
FeatureStore``: region features, size-normalized xyxy boxes and the
image-id -> row map. Loading from zarr comes with the file-backed data
layer.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


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

    def batch(self, rows: np.ndarray) -> np.ndarray:
        """(len(rows), K, feat_dim) feature||bbox tensor for a batch."""
        f = np.asarray(self.features[rows])
        b = np.asarray(self.boxes[rows])
        return np.concatenate([f, b], axis=-1)
