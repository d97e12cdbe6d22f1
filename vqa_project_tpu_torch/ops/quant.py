"""int8 quantization: the feature table's rows, and serving weights.

Counterpart of ``vqa_project_tpu/ops/quant.py``.

- ``quantize_feature_table``: per-box-row int8 of the device feature
  table, in numpy on the host; it runs once while the cache is built,
  chunk by chunk (each box row is quantized on its own, so chunking
  does not change a bit).
- Serving weights (``ModelConfig.quantized_inference``): each graph
  convolution's projection and each weight-norm layer's ``v`` become
  symmetric per-output-column int8 codes with float32 scales, once at
  load (``quantize_state_dict_for_serving``); activations are quantized
  per tensor for every product (``int8_matmul``), the sums taken in
  int32 and the two scales applied in one float32 multiply.

On CUDA tensors the int32 sums come from ``torch._int_mm`` (cuBLAS), as
the JAX package's come from XLA's ``dot_general``; no Pallas kernel
stands behind them. ``_int_mm`` takes more than 16 rows and depths and
widths that are multiples of 8: the weights are zero-padded once
(``pad_int8_weight``) and the activations per call, which changes
neither the activation's absmax nor any sum. A CUDA product that
``_int_mm`` refuses raises; nothing falls back to a float product. On
CPU tensors the plain version takes the same sums as an int32 product.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# torch._int_mm on CUDA: more than 16 rows; depth and width multiples of 8
_MIN_ROWS = 17
_ALIGN = 8


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


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-column symmetric int8 of ``w`` (in, out): (q int8 (in,
    out), scale f32 (out,)) with w ~= q * scale, scale = max(max|w[:, c]|,
    1e-12) / 127, codes rounded half to even and clipped to +-127."""
    w = w.float()
    scale = torch.clamp(w.abs().amax(dim=0), min=1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 of ``x`` taken in float32: (x_q int8, sx
    f32 scalar) with sx = max(max|x|, 1e-12) / 127."""
    x = x.float()
    sx = torch.clamp(x.abs().amax(), min=1e-12) / 127.0
    x_q = torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8)
    return x_q, sx


def pad_int8_weight(q: torch.Tensor) -> torch.Tensor:
    """(N, K) int8 codes (torch's Linear layout) zero-padded to multiples
    of 8 in both dimensions, contiguous: its ``.t()`` is the (K8, N8)
    column-major operand ``int8_matmul`` takes on CUDA."""
    n, k = q.shape
    return F.pad(q, (0, -k % _ALIGN, 0, -n % _ALIGN)).contiguous()


def padded_int_mm(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm`` of x_q (M, K) int8 and w_q (K', N') int8, with
    K' >= K and K', N' multiples of 8 (``pad_int8_weight(...).t()``):
    x_q is zero-padded to (max(M, 17), K'); returns the (M, N') int32
    sums."""
    m, k = x_q.shape
    kp, n_p = w_q.shape
    if kp < k or kp % _ALIGN or n_p % _ALIGN:
        raise ValueError(f"the int8 weight is {tuple(w_q.shape)} for a depth "
                         f"of {k}: pad it with pad_int8_weight")
    rows = max(m, _MIN_ROWS)
    x_p = F.pad(x_q, (0, kp - k, 0, rows - m)).contiguous()
    return torch._int_mm(x_p, w_q)[:m]


def int8_sums(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The (M, N') int32 sums of x_q (M, K) int8 and the first K rows of
    w_q (K', N') int8: ``padded_int_mm`` on CUDA tensors, an int32
    product on CPU tensors."""
    if x_q.device.type == "cpu":
        return torch.mm(x_q.int(), w_q[:x_q.shape[1]].int())
    if x_q.device.type != "cuda":
        raise ValueError(f"int8 products run on CPU or CUDA tensors, got "
                         f"{x_q.device}")
    return padded_int_mm(x_q, w_q)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) float times int8 weights: (M, N) float32, N = len(w_scale).

    ``w_q`` is (K', N') int8 with K' >= K and N' >= N, zero past K and N
    (on CUDA ``pad_int8_weight(codes).t()``). The activation is
    quantized per tensor (``quantize_activation``), the sums are int32
    and the result is sums * (sx * w_scale), as the JAX package's
    ``int8_matmul``."""
    x_q, sx = quantize_activation(x)
    acc = int8_sums(x_q, w_q)[:, :w_scale.shape[0]]
    return acc.float() * (sx * w_scale)


def quantize_state_dict_for_serving(sd: Mapping[str, torch.Tensor]
                                    ) -> Dict[str, torch.Tensor]:
    """The state_dict of ``GraphVQAModel(quantized_inference=True)`` from
    a float one (the reference's names): each graph convolution's n
    Linears, fused as (n*d, in), become ``conv_weights_q`` int8 and
    ``conv_weights_scale`` f32; each weight-norm layer's ``weight_v``
    and ``weight_g`` become ``weight_q`` int8 (out, in) and
    ``weight_scale`` f32 with the factor g / max(||v||, 1e-12) folded
    into the scale, so the codes quantize v and the layer computes
    g v / ||v||. The rest is kept. The counterpart of the JAX package's
    ``quantize_params_for_serving``; like it, raises ValueError when
    fewer than 3 layers convert."""
    out: Dict[str, torch.Tensor] = {}
    convs: Dict[str, Dict[int, torch.Tensor]] = {}
    converted = 0
    for key, val in sd.items():
        prefix, _, leaf = key.rpartition(".")
        if leaf == "weight_v":
            v = val.float()
            g = sd[prefix + ".weight_g"].float().reshape(-1)
            wn = g / torch.clamp(torch.linalg.vector_norm(v, dim=1),
                                 min=1e-12)
            q, scale = quantize_weight(v.t())
            out[prefix + ".weight_q"] = q.t().contiguous()
            out[prefix + ".weight_scale"] = scale * wn
            converted += 1
        elif leaf == "weight_g":
            continue
        elif ".conv_weights." in key:
            conv, rest = key.split(".conv_weights.")
            convs.setdefault(conv, {})[int(rest.split(".")[0])] = val
        else:
            out[key] = val
    for conv, weights in convs.items():
        fused = torch.cat([weights[i] for i in range(len(weights))])
        q, scale = quantize_weight(fused.float().t())
        out[conv + ".conv_weights_q"] = q.t().contiguous()
        out[conv + ".conv_weights_scale"] = scale
        converted += 1
    if converted < 3:
        raise ValueError(f"only {converted} quantizable layers found")
    return out
