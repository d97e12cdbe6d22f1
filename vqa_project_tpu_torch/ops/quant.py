"""int8 row quantization of the device feature table.

Copy of ``vqa_project_tpu/ops/quant.py::quantize_feature_table``, in
numpy on the host: it runs once while the cache is built, chunk by
chunk (each box row is quantized on its own, so chunking does not
change a bit).
"""

from __future__ import annotations

import numpy as np


def quantize_feature_table(feats):
    """Per-box-row symmetric int8: (N, K, F) -> (q int8 (N, K, F), scale
    f32 (N, K)) with feats ~= q * scale[..., None] (max error scale/2 per
    element). All-zero rows (padding boxes) get scale 1, so they quantize
    to exact zeros."""
    feats = np.asarray(feats, np.float32)
    scale = np.abs(feats).max(axis=2) / 127.0
    scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
    q = np.clip(np.rint(feats / scale[..., None]), -127,
                127).astype(np.int8)
    return q, scale
