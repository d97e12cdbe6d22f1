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
the CUDA scan in ``ops/gru_scan.py``; ``gru_scan_bwd_reference`` is its
hand-derived backward, the plain version of the backward kernels.
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
                       b_hh: torch.Tensor, qlen: torch.Tensor,
                       return_hs: bool = False, return_hp: bool = False):
    """The GRU recurrence over precomputed input projections.

    Args:
      xp:   (T, B, 3H) float32 input projections (b_ih included).
      w_hh: (3H, H) hidden weights, torch layout, in the weight dtype;
            h is cast to that dtype for the product, which accumulates
            in float32, and h itself stays float32.
      b_hh: (3H,) hidden bias.
      qlen: (B,) true lengths; h is frozen for t >= qlen.
      return_hs: also return every step's state.
      return_hp: with ``return_hs``, also every step's hidden-side
            pre-activations hp = h_prev @ W^T + b_hh (float32), which the
            persistent reverse sweep reads instead of recomputing.
    Returns:
      (B, H) float32 final hidden states; with ``return_hs`` the pair
      (final, hs (T, B, H) float32), hs[t] being the state after step t;
      with ``return_hp`` too, the triple (final, hs, hp (T, B, 3H)).
    """
    if return_hp and not return_hs:
        raise ValueError("return_hp needs return_hs")
    t_steps, b, h3 = xp.shape
    h = h3 // 3
    w_t = w_hh.t()
    b32 = b_hh.float()
    qlen = qlen.to(device=xp.device, dtype=torch.int64)
    h_prev = torch.zeros((b, h), dtype=torch.float32, device=xp.device)
    hs, hps = [], []
    for t in range(t_steps):
        hp = matmul(h_prev.to(w_hh.dtype), w_t) + b32
        hps.append(hp)
        xr, xz, xn = xp[t].split(h, dim=-1)
        hr, hz, hn = hp.split(h, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1.0 - z) * n + z * h_prev
        keep = (t < qlen)[:, None]
        h_prev = torch.where(keep, h_new, h_prev)
        hs.append(h_prev)
    if return_hp:
        return h_prev, torch.stack(hs), torch.stack(hps)
    if return_hs:
        return h_prev, torch.stack(hs)
    return h_prev


def gru_scan_bwd_reference(xp: torch.Tensor, w_hh: torch.Tensor,
                           b_hh: torch.Tensor, qlen: torch.Tensor,
                           hs: torch.Tensor, gh_final: torch.Tensor):
    """The hand-derived backward of ``gru_scan_reference``, the port of
    ``vqa_project_tpu/ops/pallas/gru_scan.py::_bwd_xla_reference``: the
    reverse sweep (``gru_scan_sweep_reference``), then dW/db hoisted out
    of the loop (``gru_wgrad_reference``).

    Args:
      xp, w_hh, b_hh, qlen: as ``gru_scan_reference`` takes them.
      hs:       (T, B, H) float32 states the forward returned.
      gh_final: (B, H) gradient of the final state.
    Returns:
      dxp (T, B, 3H) float32, dW (3H, H) float32, db (3H,) float32.
    """
    dxp, dhp = gru_scan_sweep_reference(xp, w_hh, b_hh, qlen, hs, gh_final)
    dw, db = gru_wgrad_reference(dhp, hs)
    return dxp, dw, db


def gru_scan_sweep_reference(xp: torch.Tensor, w_hh: torch.Tensor,
                             b_hh: torch.Tensor, qlen: torch.Tensor,
                             hs: torch.Tensor, gh_final: torch.Tensor,
                             hp: torch.Tensor | None = None):
    """The reverse-time sweep over the saved states, T-1 down to 0: the
    plain version of ``csrc/gru_scan_bwd.cu``'s sweeps.

    Same rounding points as the JAX reference: hp is recomputed with
    h_prev cast to the weight dtype (so the gates are the forward's),
    dhp is cast to the weight dtype for the product with W and is kept
    in it, every sum is float32, and dxp stays float32. Given ``hp``
    (T, B, 3H) float32, the forward's own (``gru_scan_reference(...,
    return_hp=True)``), the sweep reads it instead of recomputing it, as
    the persistent kernel does.

    Returns dxp (T, B, 3H) float32 and dhp (T, B, 3H) in W's dtype.
    """
    t_steps, b, h3 = xp.shape
    h = h3 // 3
    wd = w_hh.dtype
    b32 = b_hh.float()
    qlen = qlen.to(device=xp.device, dtype=torch.int64)
    h_prevs = _shift(hs)
    gh = gh_final.float()
    dxps, dhps = [None] * t_steps, [None] * t_steps
    for t in reversed(range(t_steps)):
        h_prev = h_prevs[t]
        hp_t = (matmul(h_prev.to(wd), w_hh.t()) + b32 if hp is None
                else hp[t].float())
        xr, xz, xn = xp[t].float().split(h, dim=-1)
        hr, hz, hn = hp_t.split(h, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        keep = (t < qlen)[:, None]
        g_new = torch.where(keep, gh, torch.zeros_like(gh))
        passthrough = torch.where(keep, torch.zeros_like(gh), gh)
        dz = g_new * (h_prev - n)
        dn = g_new * (1.0 - z)
        dn_pre = dn * (1.0 - n * n)
        dr = dn_pre * hn
        dhn = dn_pre * r
        dr_pre = dr * r * (1.0 - r)
        dz_pre = dz * z * (1.0 - z)
        dhps[t] = torch.cat([dr_pre, dz_pre, dhn], dim=-1).to(wd)
        dxps[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1)
        gh = passthrough + g_new * z + matmul(dhps[t], w_hh)
    return torch.stack(dxps), torch.stack(dhps)


def gru_wgrad_reference(dhp: torch.Tensor, hs: torch.Tensor):
    """dW (3H, H) = sum over (t, b) of dhp[t, b]^T h_prev[t, b], with
    h_prev = hs[t-1] (zeros at t=0) rounded to dhp's dtype, and db (3H,)
    = sum of dhp, both float32: the plain version of
    ``csrc/gru_scan_bwd.cu``'s weight-gradient kernel."""
    h3 = dhp.shape[-1]
    dw = matmul(dhp.reshape(-1, h3).t(),
                _shift(hs).reshape(-1, h3 // 3).to(dhp.dtype))
    return dw, dhp.float().sum(dim=(0, 1))


def _shift(hs: torch.Tensor) -> torch.Tensor:
    """h_prev of every step: hs moved one step later, zeros first."""
    return torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])


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
