"""GRU recurrence and its backward as CUDA kernels.

Counterpart of ``vqa_project_tpu/ops/pallas/gru_scan.py::pallas_gru``
and ``gru_encode_pallas``, forward and backward. On CUDA tensors:

- ``gru_scan`` launches the kernel of ``csrc/gru_scan.cu`` (B) once per
  time step, and with ``return_hs`` keeps every step's state;
- ``gru_scan_bwd`` launches the reverse step kernel of
  ``csrc/gru_scan_bwd.cu`` (E) once per step, T-1 down to 0;
- ``gru_wgrad`` launches E's weight-gradient kernel once.

On CPU tensors each runs its plain version of ``ops/gru.py``
(``gru_scan_reference``, ``gru_scan_sweep_reference``,
``gru_wgrad_reference``). ``GRUScanFunction`` joins them for autograd.
"""

from __future__ import annotations

import torch

from vqa_project_tpu_torch.ops import _build
from vqa_project_tpu_torch.ops.gru import (gru_scan_reference,
                                           gru_scan_sweep_reference,
                                           gru_wgrad_reference,
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
             qlen: torch.Tensor, return_hs: bool = False):
    """GRU recurrence; returns the final hidden state (B, H) float32, and
    with ``return_hs`` the pair (final, hs (T, B, H) float32).

    Args:
      xp:   (T, B, 3H) float32 input projections (b_ih included).
      w_hh: (3H, H) hidden weights in torch layout, float32 or bfloat16.
      b_hh: (3H,) float32 hidden bias.
      qlen: (B,) int32 true lengths; h is frozen for t >= qlen.
    """
    if xp.device.type == "cpu":
        return gru_scan_reference(xp, w_hh, b_hh, qlen, return_hs)
    t, b, h = _check_cuda_inputs(xp, w_hh, b_hh, qlen)
    lib = _build.load("gru_scan")
    h_a = torch.zeros((b, h), dtype=torch.float32, device=xp.device)
    h_b = None if return_hs else torch.empty_like(h_a)
    hs = (torch.empty((t, b, h), dtype=torch.float32, device=xp.device)
          if return_hs else None)
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    rc = lib.gru_scan_fwd(
        xp.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), qlen.data_ptr(),
        h_a.data_ptr(), None if h_b is None else h_b.data_ptr(),
        None if hs is None else hs.data_ptr(), t, b, h,
        _DTYPE_CODE[w_hh.dtype], stream)
    _build.check(rc, "gru_scan_fwd")
    gru_scan.launches += t  # one kernel launch per time step
    if return_hs:
        return hs[-1], hs
    return h_a if t % 2 == 0 else h_b


gru_scan.launches = 0


def gru_scan_bwd(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                 qlen: torch.Tensor, hs: torch.Tensor,
                 gh_final: torch.Tensor):
    """Reverse sweep over the saved states hs (T, B, H) float32 from the
    final state's gradient gh_final (B, H) float32: (dxp (T, B, 3H)
    float32, dhp (T, B, 3H) in W's dtype), as
    ``gru_scan_sweep_reference`` returns them."""
    if xp.device.type == "cpu":
        return gru_scan_sweep_reference(xp, w_hh, b_hh, qlen, hs, gh_final)
    t, b, h = _check_cuda_inputs(xp, w_hh, b_hh, qlen)
    dev = xp.device
    for name, x in (("hs", hs), ("gh_final", gh_final)):
        if x.device != dev or x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(hs.shape) != (t, b, h) or tuple(gh_final.shape) != (b, h):
        raise ValueError("hs must be (T, B, H) and gh_final (B, H)")
    lib = _build.load("gru_scan_bwd")
    w_t = w_hh.t().contiguous()            # columns of W as coalesced rows
    dxp = torch.empty_like(xp)
    dhp = torch.empty(xp.shape, dtype=w_hh.dtype, device=dev)
    # carry: the gradient of h_out for the next step down, ping-ponged
    bufs = (torch.empty_like(gh_final), torch.empty_like(gh_final))
    c_in = gh_final
    stream = torch.cuda.current_stream(dev).cuda_stream
    for i, step in enumerate(reversed(range(t))):
        c_out = bufs[i % 2]
        rc = lib.gru_scan_bwd_step(
            xp[step].data_ptr(), w_hh.data_ptr(), w_t.data_ptr(),
            b_hh.data_ptr(), qlen.data_ptr(),
            hs[step - 1].data_ptr() if step else None,
            dhp[step + 1].data_ptr() if step < t - 1 else None,
            c_in.data_ptr(), dxp[step].data_ptr(), dhp[step].data_ptr(),
            c_out.data_ptr(), b, h, step, _DTYPE_CODE[w_hh.dtype], stream)
        _build.check(rc, "gru_scan_bwd_step")
        c_in = c_out
    gru_scan_bwd.launches += t  # one kernel launch per time step
    return dxp, dhp


gru_scan_bwd.launches = 0


def gru_wgrad(dhp: torch.Tensor, hs: torch.Tensor):
    """dW (3H, H) and db (3H,), float32, as ``gru_wgrad_reference``
    returns them. One launch on CUDA tensors."""
    if dhp.device.type == "cpu":
        return gru_wgrad_reference(dhp, hs)
    t, b, h3 = dhp.shape
    h = h3 // 3
    if dhp.dtype not in _DTYPE_CODE:
        raise TypeError(f"dhp must be float32 or bfloat16, got {dhp.dtype}")
    if (hs.dtype != torch.float32 or tuple(hs.shape) != (t, b, h)
            or hs.device != dhp.device):
        raise ValueError(f"hs must be float32 {(t, b, h)} on {dhp.device}")
    if not (dhp.is_contiguous() and hs.is_contiguous()):
        raise ValueError("dhp and hs must be contiguous")
    lib = _build.load("gru_scan_bwd")
    dw = torch.empty((h3, h), dtype=torch.float32, device=dhp.device)
    db = torch.empty((h3,), dtype=torch.float32, device=dhp.device)
    stream = torch.cuda.current_stream(dhp.device).cuda_stream
    rc = lib.gru_wgrad(dhp.data_ptr(), hs.data_ptr(), dw.data_ptr(),
                       db.data_ptr(), t, b, h, _DTYPE_CODE[dhp.dtype], stream)
    _build.check(rc, "gru_wgrad")
    gru_wgrad.launches += 1
    return dw, db


gru_wgrad.launches = 0


class GRUScanFunction(torch.autograd.Function):
    """Autograd of the recurrence: the forward keeps every step's state,
    the backward is the reverse sweep over them with no forward
    recompute beyond each step's gates. Gradients flow to xp, w_hh and
    b_hh (in their own dtypes); qlen has none."""

    @staticmethod
    def forward(ctx, xp, w_hh, b_hh, qlen):
        h_final, hs = gru_scan(xp, w_hh, b_hh, qlen, return_hs=True)
        ctx.save_for_backward(xp, w_hh, b_hh, qlen, hs)
        return h_final

    @staticmethod
    def backward(ctx, gh_final):
        xp, w_hh, b_hh, qlen, hs = ctx.saved_tensors
        dxp, dhp = gru_scan_bwd(xp, w_hh, b_hh, qlen, hs,
                                gh_final.float().contiguous())
        dw, db = gru_wgrad(dhp, hs)
        return dxp, dw.to(w_hh.dtype), db.to(b_hh.dtype), None


def gru_encode_kernel(emb: torch.Tensor, qlen: torch.Tensor,
                      w_ih: torch.Tensor, w_hh: torch.Tensor,
                      b_ih: torch.Tensor, b_hh: torch.Tensor,
                      compute_dtype: torch.dtype = torch.bfloat16
                      ) -> torch.Tensor:
    """``ops.gru.gru_encode`` with the recurrence in ``gru_scan``, and
    differentiable through ``GRUScanFunction`` when grad is enabled.

    The input projection stays a plain matmul in the compute dtype with
    float32 accumulation (its gradient is plain autograd, as XLA computes
    it outside the TPU kernel); W_hh is cast to the compute dtype.
    """
    xp = input_projection(emb, w_ih, b_ih, compute_dtype)
    args = (xp, w_hh.to(compute_dtype).contiguous(), b_hh.float().contiguous(),
            qlen.to(device=xp.device, dtype=torch.int32))
    if torch.is_grad_enabled() and any(a.requires_grad for a in args[:3]):
        return GRUScanFunction.apply(*args)
    return gru_scan(*args)
