"""Graph and sequence ops of the port; kernels live in ``edge_aggregate``,
``graph_block``, ``gather_rows`` and ``gru_scan``, built from ``csrc/``
by ``_build``. The module ``gru_scan`` keeps its name here; import its
wrappers from it."""

from vqa_project_tpu_torch.ops.coords import bbox_centres, polar_pseudo_coords
from vqa_project_tpu_torch.ops.edge_aggregate import (
    fused_sel_aggregate_act, sel_aggregate_act_reference)
from vqa_project_tpu_torch.ops.gaussian import gaussian_kernel_weights
from vqa_project_tpu_torch.ops.graph_block import (
    fused_graph_block, fused_graph_block_reference, select_both, tile_gemm)
from vqa_project_tpu_torch.ops.gru import gru_encode, gru_scan_reference
from vqa_project_tpu_torch.ops.gru_scan import gru_encode_kernel
from vqa_project_tpu_torch.ops.losses import (multilabel_soft_margin_loss,
                                              soft_margin_per_sample,
                                              vqa_score)
from vqa_project_tpu_torch.ops.neighbourhood import masked_neighbourhood

__all__ = [
    "bbox_centres", "polar_pseudo_coords", "gaussian_kernel_weights",
    "masked_neighbourhood", "gru_encode", "gru_scan_reference",
    "gru_encode_kernel", "fused_sel_aggregate_act",
    "sel_aggregate_act_reference", "fused_graph_block",
    "fused_graph_block_reference", "select_both", "tile_gemm",
    "multilabel_soft_margin_loss", "soft_margin_per_sample", "vqa_score",
]
