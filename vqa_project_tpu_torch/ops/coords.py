"""Bounding-box geometry: centres and pairwise polar pseudo-coordinates.

Counterpart of ``vqa_project_tpu/ops/coords.py``.
"""

from __future__ import annotations

import torch


def bbox_centres(image_features: torch.Tensor) -> torch.Tensor:
    """(B, K, feat_dim) with an xyxy box in the trailing 4 channels ->
    (B, K, 2) box centres ``(cx, cy)``."""
    bb = image_features[..., -4:]
    size = bb[..., 2:] - bb[..., :2]          # (dx, dy)
    return bb[..., :2] + 0.5 * size


def polar_pseudo_coords(bb_centre: torch.Tensor) -> torch.Tensor:
    """(B, K, 2) centres -> (B, K, K, 2) stacked (rho, theta), in float32.

    theta is ``atan2(dx, dy)``: the (x, y) argument order measures the
    angle from the +y axis, as the reference model does.
    """
    c = bb_centre.float()
    diff = c[:, :, None, :] - c[:, None, :, :]           # (B, K, K, 2)
    rho = torch.sqrt(diff[..., 0] ** 2 + diff[..., 1] ** 2)
    theta = torch.atan2(diff[..., 0], diff[..., 1])
    return torch.stack([rho, theta], dim=-1)
