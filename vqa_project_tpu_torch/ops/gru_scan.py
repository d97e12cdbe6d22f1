"""GRU recurrence as a CUDA kernel.

Counterpart of ``vqa_project_tpu/ops/pallas/gru_scan.py::pallas_gru``
and ``gru_encode_pallas``, inference forward. On CUDA tensors
``gru_scan`` launches the kernel of ``csrc/gru_scan.cu`` once per time
step; on CPU tensors it runs ``ops.gru.gru_scan_reference``.
"""

from __future__ import annotations

import torch

from vqa_project_tpu_torch.ops import _build
from vqa_project_tpu_torch.ops.gru import (gru_scan_reference,
                                           input_projection)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_cuda_inputs(xp, w_hh, b_hh, qlen):
    dev = xp.device
    for name, t in (("w_hh", w_hh), ("b_hh", b_hh), ("qlen", qlen)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, xp on {dev}")
    if xp.dtype != torch.float32 or b_hh.dtype != torch.float32:
        raise TypeError("xp and b_hh must be float32")
    if w_hh.dtype not in _DTYPE_CODE:
        raise TypeError(f"w_hh must be float32 or bfloat16, got {w_hh.dtype}")
    if qlen.dtype != torch.int32:
        raise TypeError(f"qlen must be int32, got {qlen.dtype}")
    if xp.dim() != 3 or xp.shape[-1] % 3:
        raise ValueError(f"xp must be (T, B, 3H), got {tuple(xp.shape)}")
    t, b, h3 = xp.shape
    h = h3 // 3
    if tuple(w_hh.shape) != (h3, h):
        raise ValueError(f"w_hh must be {(h3, h)}, got {tuple(w_hh.shape)}")
    if tuple(b_hh.shape) != (h3,) or tuple(qlen.shape) != (b,):
        raise ValueError("b_hh must be (3H,) and qlen (B,)")
    if h % 8:
        raise ValueError(f"the kernel needs H % 8 == 0, got H={h}")
    for name, tt in (("xp", xp), ("w_hh", w_hh), ("b_hh", b_hh),
                     ("qlen", qlen)):
        if not tt.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return t, b, h


def gru_scan(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
             qlen: torch.Tensor) -> torch.Tensor:
    """GRU recurrence; returns the final hidden state (B, H) float32.

    Args:
      xp:   (T, B, 3H) float32 input projections (b_ih included).
      w_hh: (3H, H) hidden weights in torch layout, float32 or bfloat16.
      b_hh: (3H,) float32 hidden bias.
      qlen: (B,) int32 true lengths; h is frozen for t >= qlen.
    """
    if xp.device.type == "cpu":
        return gru_scan_reference(xp, w_hh, b_hh, qlen)
    t, b, h = _check_cuda_inputs(xp, w_hh, b_hh, qlen)
    lib = _build.load("gru_scan")
    h_a = torch.zeros((b, h), dtype=torch.float32, device=xp.device)
    h_b = torch.empty_like(h_a)
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    rc = lib.gru_scan_fwd(
        xp.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), qlen.data_ptr(),
        h_a.data_ptr(), h_b.data_ptr(), t, b, h, _DTYPE_CODE[w_hh.dtype],
        stream)
    _build.check(rc, "gru_scan_fwd")
    gru_scan.launches += t  # one kernel launch per time step
    return h_a if t % 2 == 0 else h_b


gru_scan.launches = 0


def gru_encode_kernel(emb: torch.Tensor, qlen: torch.Tensor,
                      w_ih: torch.Tensor, w_hh: torch.Tensor,
                      b_ih: torch.Tensor, b_hh: torch.Tensor,
                      compute_dtype: torch.dtype = torch.bfloat16
                      ) -> torch.Tensor:
    """``ops.gru.gru_encode`` with the recurrence in ``gru_scan``.

    The input projection stays a plain matmul in the compute dtype with
    float32 accumulation; W_hh is cast to the compute dtype.
    """
    xp = input_projection(emb, w_ih, b_ih, compute_dtype)
    return gru_scan(xp, w_hh.to(compute_dtype).contiguous(),
                    b_hh.float().contiguous(),
                    qlen.to(device=xp.device, dtype=torch.int32))
