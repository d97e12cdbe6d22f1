"""Masked GRU question encoder, plain PyTorch.

Counterpart of ``vqa_project_tpu/ops/gru.py``. Gate math matches
``torch.nn.GRU`` (gate order [r; z; n], separate input and hidden
biases, the reset gate applied to the hidden candidate's
pre-activation); a fixed-length scan freezes h once t >= qlen, which
equals the packed-sequence result:

    r = sigmoid(x Wir^T + bir + h Whr^T + bhr)
    z = sigmoid(x Wiz^T + biz + h Whz^T + bhz)
    n = tanh(x Win^T + bin + r * (h Whn^T + bhn))
    h' = (1 - z) * n + z * h

The input projection for all steps is hoisted into one matmul, so the
sequential part is only the (B, H) x (H, 3H) recurrence.
``gru_scan_reference`` is that recurrence alone: the plain version of
the CUDA scan in ``ops/gru_scan.py``.
"""

from __future__ import annotations

import torch

from vqa_project_tpu_torch.ops.matmul import matmul


def input_projection(emb: torch.Tensor, w_ih: torch.Tensor,
                     b_ih: torch.Tensor,
                     compute_dtype: torch.dtype) -> torch.Tensor:
    """(B, T, E) embeddings -> (T, B, 3H) float32 ``emb @ W_ih^T + b_ih``,
    the operands in the compute dtype and the sum in float32."""
    xp = matmul(emb.to(compute_dtype), w_ih.to(compute_dtype).t()) \
        + b_ih.float()
    return xp.transpose(0, 1).contiguous()


def gru_scan_reference(xp: torch.Tensor, w_hh: torch.Tensor,
                       b_hh: torch.Tensor,
                       qlen: torch.Tensor) -> torch.Tensor:
    """The GRU recurrence over precomputed input projections.

    Args:
      xp:   (T, B, 3H) float32 input projections (b_ih included).
      w_hh: (3H, H) hidden weights, torch layout, in the weight dtype;
            h is cast to that dtype for the product, which accumulates
            in float32, and h itself stays float32.
      b_hh: (3H,) hidden bias.
      qlen: (B,) true lengths; h is frozen for t >= qlen.
    Returns:
      (B, H) float32 final hidden states.
    """
    t_steps, b, h3 = xp.shape
    h = h3 // 3
    w_t = w_hh.t()
    b32 = b_hh.float()
    qlen = qlen.to(device=xp.device, dtype=torch.int64)
    h_prev = torch.zeros((b, h), dtype=torch.float32, device=xp.device)
    for t in range(t_steps):
        hp = matmul(h_prev.to(w_hh.dtype), w_t) + b32
        xr, xz, xn = xp[t].split(h, dim=-1)
        hr, hz, hn = hp.split(h, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1.0 - z) * n + z * h_prev
        keep = (t < qlen)[:, None]
        h_prev = torch.where(keep, h_new, h_prev)
    return h_prev


def gru_encode(emb: torch.Tensor, qlen: torch.Tensor, w_ih: torch.Tensor,
               w_hh: torch.Tensor, b_ih: torch.Tensor, b_hh: torch.Tensor,
               *, compute_dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    """Run the GRU and return each sequence's hidden state at qlen-1.

    Args:
      emb:  (B, T, E) embedded question tokens (fixed T).
      qlen: (B,) int true lengths, 1 <= qlen <= T.
      w_ih: (3H, E) input weights, torch layout [r; z; n].
      w_hh: (3H, H) hidden weights.
      b_ih, b_hh: (3H,) biases.
    Returns:
      (B, H) float32 final hidden states.
    """
    xp = input_projection(emb, w_ih, b_ih, compute_dtype)
    return gru_scan_reference(xp, w_hh.to(compute_dtype), b_hh, qlen)
