"""Top-m neighbourhood selection as dense masked edge weights.

Counterpart of ``vqa_project_tpu/ops/neighbourhood.py::masked_neighbourhood``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def masked_neighbourhood(
    adjacency: torch.Tensor, neighbourhood_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-m neighbourhood as a dense mask and a masked softmax.

    The m-th largest value of each row is the threshold; every entry
    above it is selected and the remaining slots go to entries equal to
    it, lowest index first, so exactly m entries are selected per row
    even when the row is all equal (a ReLU-dead node gives an all-zero
    row). ``torch.topk`` is not used because CUDA promises no tie order.

    Returns:
      alpha: (B, K, K) float32 softmaxed edge weights, 0 outside top-m.
      mask:  (B, K, K) float32, 1.0 on the exactly-m selected edges.
    """
    adj = adjacency.float()
    k = adj.shape[-1]
    sorted_asc = torch.sort(adj, dim=-1).values
    thr = sorted_asc[..., k - neighbourhood_size:
                     k - neighbourhood_size + 1]          # m-th largest
    gt = adj > thr
    n_gt = gt.sum(dim=-1, keepdim=True)
    tie = adj == thr
    tie_rank = torch.cumsum(tie.to(torch.int32), dim=-1)
    quota = neighbourhood_size - n_gt
    mask = (gt | (tie & (tie_rank <= quota))).float()
    alpha = torch.softmax(
        adj.masked_fill(mask == 0, float("-inf")), dim=-1)
    return alpha, mask
