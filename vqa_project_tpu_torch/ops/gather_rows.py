"""Row gathers from the device feature cache as CUDA kernels.

Counterpart of ``vqa_project_tpu/ops/pallas/gather_rows.py``. On CUDA
tensors:

- ``gather_rows_packed`` launches kernel F of ``csrc/gather_rows.cu``
  (the TPU's ring-buffered DMA gather, ``gather_rows_dma``): all B rows
  of an (N, K, F) table in one launch, and for an int8 table the per-box
  dequantization ``(float(q) * scales[row, k])`` rounded once to
  ``out_dtype``;
- ``gather_rows_blocked`` launches kernel G (the TPU's blocked gather):
  one block per row, any row shape;
- ``gather_image_rows`` launches G's redesign, the cache-mode step's
  whole image in one launch: F's features and the boxes gathered
  together, converted to the compute dtype and written straight into
  the model's node rows ``feat||bbox`` (padded for the merged block),
  with the f32 boxes beside them (a ``NodeImage``);
- ``gather_region_rows`` gathers a feature-only image for MCAN (a
  ``RegionImage``): kernel F's launch of the rows in the table's dtype,
  and each row's region count beside them.

Rows are clamped to [0, N), as ``jnp.take(mode="clip")`` does. On CPU
tensors each takes its plain version: ``gather_rows_reference``
(``index_select`` of the clamped rows plus the same dequantization), or
``gather_image_reference`` (that, then the cast and the concatenation).
There is no VJP: the table is data, not a parameter.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from vqa_project_tpu_torch.ops import _build
from vqa_project_tpu_torch.ops.graph_block import ROW_ALIGN, padded_rows

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1}


def gather_rows_reference(table: torch.Tensor, rows: torch.Tensor,
                          scales: Optional[torch.Tensor] = None,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """table[clamp(rows, 0, N-1)]; with ``scales`` (N, K) the int8 rows
    are dequantized as ``(q.float() * scale).to(out_dtype)`` (default
    float32)."""
    r = rows.clamp(0, table.shape[0] - 1)
    out = table.index_select(0, r)
    if scales is None:
        return out
    sc = scales.index_select(0, r)
    return (out.float() * sc[:, :, None]).to(out_dtype or torch.float32)


def _check_rows(table: torch.Tensor, rows: torch.Tensor) -> None:
    if rows.dim() != 1 or rows.dtype != torch.int32:
        raise TypeError(f"rows must be a (B,) int32 tensor, got "
                        f"{rows.dtype} {tuple(rows.shape)}")
    if rows.device != table.device:
        raise ValueError(f"rows on {rows.device}, table on {table.device}")
    if table.dim() < 1 or table.shape[0] == 0:
        raise ValueError("the table has no rows")


def gather_rows_packed(table: torch.Tensor, rows: torch.Tensor,
                       scales: Optional[torch.Tensor] = None,
                       out_dtype: Optional[torch.dtype] = None,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, K, F) rows of an (N, K, F) table in one launch (kernel F).

    table: float32, bfloat16 or int8; rows (B,) int32, clamped. With
    ``scales`` (N, K) float32 the table must be int8 and the rows come
    out dequantized in ``out_dtype`` (float32 or bfloat16); without, they
    come out in the table's dtype. ``out``, a contiguous (B, K, F) tensor
    of the result's dtype, is written and returned instead of a new one.
    """
    _check_rows(table, rows)
    if table.dim() != 3:
        raise ValueError(f"table must be (N, K, F), got {tuple(table.shape)}")
    n, k, f = table.shape
    if scales is not None:
        if table.dtype != torch.int8:
            raise TypeError("scales need an int8 table")
        if (scales.dtype != torch.float32 or tuple(scales.shape) != (n, k)
                or scales.device != table.device):
            raise ValueError(f"scales must be float32 {(n, k)} on "
                             f"{table.device}")
        out_dtype = out_dtype or torch.float32
        if out_dtype not in _OUT_CODE:
            raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                            f"{out_dtype}")
    elif out_dtype not in (None, table.dtype):
        raise TypeError("out_dtype differs from the table's dtype only "
                        "when dequantizing an int8 table with scales")
    b = rows.shape[0]
    want = (b, k, f), out_dtype or table.dtype
    if out is not None and ((tuple(out.shape), out.dtype) != want
                            or out.device != table.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {want[1]} {want[0]} "
                         f"tensor on {table.device}")
    if table.device.type == "cpu":
        res = gather_rows_reference(table, rows, scales, out_dtype)
        return res if out is None else out.copy_(res)
    if table.dtype not in _DTYPE_CODE:
        raise TypeError(f"table must be float32, bfloat16 or int8, got "
                        f"{table.dtype}")
    if not (table.is_contiguous() and rows.is_contiguous()
            and (scales is None or scales.is_contiguous())):
        raise ValueError("table, rows and scales must be contiguous")
    if scales is None and ((k * f * table.element_size()) % 16
                           or table.data_ptr() % 16):
        raise ValueError("kernel F copies 16-byte vectors: the row bytes "
                         "and the table's address must be multiples of 16 "
                         "(gather_rows_blocked takes any row)")
    if out is None:
        out = torch.empty(want[0], dtype=want[1], device=table.device)
    if b == 0:
        return out
    lib = _build.load("gather_rows")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    rc = lib.gather_rows_packed(
        table.data_ptr(), None if scales is None else scales.data_ptr(),
        rows.data_ptr(), out.data_ptr(), n, b, k, f,
        _DTYPE_CODE[table.dtype],
        _OUT_CODE.get(out.dtype, 0) if scales is not None else 0, stream)
    _build.check(rc, "gather_rows_packed")
    gather_rows_packed.launches += 1
    return out


_build.counted(gather_rows_packed)


def gather_rows_blocked(table: torch.Tensor, rows: torch.Tensor
                        ) -> torch.Tensor:
    """table[clamp(rows)] for a table of any row shape and dtype, one
    block per row (kernel G)."""
    _check_rows(table, rows)
    if table.device.type == "cpu":
        return gather_rows_reference(table, rows)
    if not (table.is_contiguous() and rows.is_contiguous()):
        raise ValueError("table and rows must be contiguous")
    b = rows.shape[0]
    out = torch.empty((b, *table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    row_bytes = table[0].numel() * table.element_size()
    if b == 0 or row_bytes == 0:
        return out
    # the widest element that divides the row and both addresses
    width = next(w for w in (16, 8, 4, 2, 1)
                 if row_bytes % w == 0 and table.data_ptr() % w == 0
                 and out.data_ptr() % w == 0)
    lib = _build.load("gather_rows")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    rc = lib.gather_rows_blocked(table.data_ptr(), rows.data_ptr(),
                                 out.data_ptr(), table.shape[0], b,
                                 row_bytes, width, stream)
    _build.check(rc, "gather_rows_blocked")
    gather_rows_blocked.launches += 1
    return out


_build.counted(gather_rows_blocked)


class NodeImage(NamedTuple):
    """A batch of images as the model reads them, from one gather: the
    node rows feat||bbox in the compute dtype, the (B, K, F + 4) view of
    rows at a stride of F + 4 or, for the merged block, padded with zeros
    to a multiple of ``ROW_ALIGN``; and the boxes in float32 for the
    pseudo-coordinates."""

    nodes: torch.Tensor      # (B, K, F + 4)
    boxes: torch.Tensor      # (B, K, 4) float32


def node_row_stride(width: int, padded: bool) -> int:
    """The row stride of a NodeImage's nodes of ``width`` columns."""
    return -(-width // ROW_ALIGN) * ROW_ALIGN if padded else width


def gather_image_reference(features: torch.Tensor, boxes: torch.Tensor,
                           rows: torch.Tensor,
                           scales: Optional[torch.Tensor] = None,
                           node_dtype: torch.dtype = torch.float32,
                           padded: bool = False) -> NodeImage:
    """The plain ``gather_image_rows``: both tables gathered by
    ``gather_rows_reference`` (an int8 table dequantized to
    ``node_dtype``), then cast to ``node_dtype`` and concatenated, into
    padded rows (``padded_rows``) when ``padded``."""
    feats = gather_rows_reference(features, rows, scales, node_dtype)
    bx = gather_rows_reference(boxes, rows)
    if padded:
        nodes = padded_rows([feats, bx], node_dtype)
    else:
        nodes = torch.cat([feats.to(node_dtype), bx.to(node_dtype)], dim=-1)
    return NodeImage(nodes, bx)


def gather_image_rows(features: torch.Tensor, boxes: torch.Tensor,
                      rows: torch.Tensor,
                      scales: Optional[torch.Tensor] = None,
                      node_dtype: torch.dtype = torch.float32,
                      padded: bool = False,
                      out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                      ) -> NodeImage:
    """A batch's images from the device cache in one launch (kernel G's
    redesign): ``NodeImage(nodes, boxes)`` of the clamped ``rows``.

    features (N, K, F) float32, bfloat16 or int8 (int8 with its (N, K)
    float32 ``scales``, dequantized as kernel F does); boxes (N, K, 4)
    float32; rows (B,) int32. nodes are feat||bbox in ``node_dtype``
    (float32 or bfloat16), the (B, K, F + 4) view of rows at stride
    ``node_row_stride(F + 4, padded)``, their pad columns 0. ``out``, a
    pair of contiguous tensors (B, K, that stride) of ``node_dtype`` and
    (B, K, 4) float32, is written instead of new ones.
    """
    _check_rows(features, rows)
    if features.dim() != 3:
        raise ValueError(f"features must be (N, K, F), got "
                         f"{tuple(features.shape)}")
    n, k, f = features.shape
    if (boxes.dtype != torch.float32 or tuple(boxes.shape) != (n, k, 4)
            or boxes.device != features.device):
        raise ValueError(f"boxes must be float32 {(n, k, 4)} on "
                         f"{features.device}, got {boxes.dtype} "
                         f"{tuple(boxes.shape)} on {boxes.device}")
    if features.dtype not in _DTYPE_CODE:
        raise TypeError(f"features must be float32, bfloat16 or int8, got "
                        f"{features.dtype}")
    if (features.dtype == torch.int8) != (scales is not None):
        raise TypeError("an int8 table needs its scales, and only an int8 "
                        "table takes scales")
    if scales is not None and (scales.dtype != torch.float32
                               or tuple(scales.shape) != (n, k)
                               or scales.device != features.device):
        raise ValueError(f"scales must be float32 {(n, k)} on "
                         f"{features.device}")
    if node_dtype not in _OUT_CODE:
        raise TypeError(f"node_dtype must be float32 or bfloat16, got "
                        f"{node_dtype}")
    b, ld = rows.shape[0], node_row_stride(f + 4, padded)
    if out is not None:
        buf, bx = out
        if ((tuple(buf.shape), buf.dtype) != ((b, k, ld), node_dtype)
                or (tuple(bx.shape), bx.dtype) != ((b, k, 4), torch.float32)
                or any(t.device != features.device or not t.is_contiguous()
                       for t in out)):
            raise ValueError(f"out must be contiguous {node_dtype} "
                             f"{(b, k, ld)} and float32 {(b, k, 4)} "
                             f"tensors on {features.device}")
    if features.device.type == "cpu":
        res = gather_image_reference(features, boxes, rows, scales,
                                     node_dtype, padded)
        if out is None:
            return res
        buf[..., :f + 4].copy_(res.nodes)
        buf[..., f + 4:].zero_()
        return NodeImage(buf[..., :f + 4], bx.copy_(res.boxes))
    if not all(t.is_contiguous() for t in (features, boxes, rows, scales)
               if t is not None):
        raise ValueError("features, boxes, rows and scales must be "
                         "contiguous")
    if out is None:
        buf = torch.empty((b, k, ld), dtype=node_dtype,
                          device=features.device)
        bx = torch.empty((b, k, 4), dtype=torch.float32,
                         device=features.device)
    if b > 0:
        lib = _build.load("gather_rows")
        stream = torch.cuda.current_stream(features.device).cuda_stream
        rc = lib.gather_image_rows(
            features.data_ptr(),
            None if scales is None else scales.data_ptr(), boxes.data_ptr(),
            rows.data_ptr(), buf.data_ptr(), bx.data_ptr(), n, b, k, f, ld,
            _DTYPE_CODE[features.dtype], _OUT_CODE[node_dtype], stream)
        _build.check(rc, "gather_image_rows")
        gather_image_rows.launches += 1
    return NodeImage(buf[..., :f + 4], bx)


_build.counted(gather_image_rows)


class RegionImage(NamedTuple):
    """A batch of images as MCAN reads them: the region rows (B, K, F) as
    the table holds them, and each image's count of regions (B,) int32,
    its live rows being the first ``count``; the rows after them are the
    table's zero rows."""

    feats: torch.Tensor      # (B, K, F)
    count: torch.Tensor      # (B,) int32


def gather_region_rows(features: torch.Tensor, counts: torch.Tensor,
                       rows: torch.Tensor) -> RegionImage:
    """``RegionImage`` of the clamped ``rows`` (B,) int32 of a (N, K, F)
    feature table and its (N,) int32 region counts, on the table's
    device: the rows by ``gather_rows_packed`` (one launch of kernel F on
    CUDA tensors), the counts by an ``index_select`` of the same rows."""
    if counts.dtype != torch.int32 or tuple(counts.shape) != (
            features.shape[0],) or counts.device != features.device:
        raise ValueError(f"counts must be int32 {(features.shape[0],)} on "
                         f"{features.device}")
    feats = gather_rows_packed(features, rows)
    return RegionImage(feats, counts.index_select(
        0, rows.clamp(0, features.shape[0] - 1)))
