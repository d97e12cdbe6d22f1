"""GRU recurrence and its backward as CUDA kernels.

Counterpart of ``vqa_project_tpu/ops/pallas/gru_scan.py::pallas_gru``
and ``gru_encode_pallas``, forward and backward. On CUDA tensors:

- ``gru_scan`` launches kernel B of ``csrc/gru_scan.cu``: the persistent
  tensor-core kernel once per call, or the per-step SIMT kernel once per
  time step, as ``scan_kernel`` decides; with ``return_hs`` it keeps
  every step's state in f32 and, for bf16 weights, in bf16;
- ``gru_scan_bwd`` launches kernel E's reverse sweep of
  ``csrc/gru_scan_bwd.cu``: the persistent tensor-core sweep once per
  call, reading the forward's hp, or the per-step SIMT kernel once per
  step, T-1 down to 0, as ``sweep_kernel`` decides;
- ``gru_wgrad`` launches E's weight-gradient kernel once: the wgmma
  product of ``csrc/gru_wgrad.cu`` or the SIMT reduction of
  ``csrc/gru_scan_bwd.cu``, as ``wgrad_kernel`` decides.

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


def scan_kernel(dtype: torch.dtype, b: int, h: int) -> str:
    """Which kernel B runs a recurrence with weights of ``dtype``, batch
    ``b`` and width ``h`` on the card.

    "persistent" (``gru_scan_persistent``: one cooperative launch for
    all T steps, W_hh resident in shared memory, mma.sync on the tensor
    cores) for bf16 weights with 1 <= B <= 256, H % 64 == 0 and
    H <= 1024: the H / 8 blocks, one per SM, and their shared memory
    hold that shape. "per_step" (``gru_scan_fwd``: one launch per time
    step on the SIMT cores) for everything else, f32 weights above all:
    their product stays exact f32, with no TF32 rounding.
    """
    if (dtype == torch.bfloat16 and 1 <= b <= 256 and h % 64 == 0
            and h <= 1024):
        return "persistent"
    return "per_step"


def sweep_kernel(dtype: torch.dtype, b: int, h: int) -> str:
    """Which reverse sweep of kernel E runs the backward of a recurrence
    with weights of ``dtype``, batch ``b`` and width ``h`` on the card.

    "persistent" (``gru_scan_bwd_persistent``: one cooperative launch for
    all T steps, W's columns resident in shared memory, mma.sync on the
    tensor cores) exactly where ``scan_kernel`` picks kernel B's
    persistent kernel (bf16 weights, 1 <= B <= 256, H % 64 == 0,
    H <= 1024: every batch the model runs), since the sweep reads the hp
    that only that kernel writes. "per_step" (``gru_scan_bwd_step``: one
    launch per reverse step on the SIMT cores, hp recomputed) for the
    rest, f32 weights above all.
    """
    return scan_kernel(dtype, b, h)


def wgrad_kernel(dtype: torch.dtype, h: int) -> str:
    """Which kernel computes dW/db for ``dhp`` of ``dtype`` at width
    ``h`` on the card: "wgmma" (``gru_wgrad_wgmma``, bf16 operands dhp
    and hs16 through TMA) for bf16 with H % 64 == 0, else "simt"
    (``gru_wgrad``, f32 states, exact f32 sums for f32 weights)."""
    return "wgmma" if dtype == torch.bfloat16 and h % 64 == 0 else "simt"


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
             qlen: torch.Tensor, return_hs: bool = False,
             return_hp: bool = False):
    """GRU recurrence; returns the final hidden state (B, H) float32, and
    with ``return_hs`` the triple (final, hs, hs16): every step's state
    hs (T, B, H) float32 and, for bf16 weights, its bf16 rounding hs16
    (T, B, H), the operand of the weight gradient (None for f32
    weights). With ``return_hp`` as well, the quadruple (final, hs, hs16,
    hp): hp (T, B, 3H) float32 = h_prev @ W^T + b_hh of every step, which
    the persistent reverse sweep reads; only the persistent kernel keeps
    it (``scan_kernel``), so on the card other shapes raise.

    Args:
      xp:   (T, B, 3H) float32 input projections (b_ih included).
      w_hh: (3H, H) hidden weights in torch layout, float32 or bfloat16.
      b_hh: (3H,) float32 hidden bias.
      qlen: (B,) int32 true lengths; h is frozen for t >= qlen.
    """
    if return_hp and not return_hs:
        raise ValueError("return_hp needs return_hs")
    bf16 = w_hh.dtype == torch.bfloat16
    if xp.device.type == "cpu":
        if not return_hs:
            return gru_scan_reference(xp, w_hh, b_hh, qlen)
        final, hs, *hp = gru_scan_reference(xp, w_hh, b_hh, qlen, True,
                                            return_hp)
        return (final, hs, hs.to(torch.bfloat16) if bf16 else None, *hp)
    t, b, h = _check_cuda_inputs(xp, w_hh, b_hh, qlen)
    dev = xp.device
    lib = _build.load("gru_scan")
    stream = torch.cuda.current_stream(dev).cuda_stream
    hs = (torch.empty((t, b, h), dtype=torch.float32, device=dev)
          if return_hs else None)
    if scan_kernel(w_hh.dtype, b, h) == "persistent":
        # h16: the bf16 operand of every step (training keeps them all)
        h16 = torch.empty((t if return_hs else 2, b, h),
                          dtype=torch.bfloat16, device=dev)
        final = (None if return_hs else
                 torch.empty((b, h), dtype=torch.float32, device=dev))
        hp = (torch.empty((t, b, 3 * h), dtype=torch.float32, device=dev)
              if return_hp else None)
        counter = torch.empty((1,), dtype=torch.int32, device=dev)
        rc = lib.gru_scan_persistent(
            xp.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            qlen.data_ptr(), None if final is None else final.data_ptr(),
            None if hs is None else hs.data_ptr(),
            None if hp is None else hp.data_ptr(), h16.data_ptr(),
            counter.data_ptr(), t, b, h, stream)
        _build.check(rc, "gru_scan_persistent")
        gru_scan.launches += 1  # one launch for all T steps
        if return_hp:
            return hs[-1], hs, h16, hp
        if return_hs:
            return hs[-1], hs, h16
        return final
    if return_hp:
        raise ValueError("only the persistent kernel keeps hp; "
                         f"scan_kernel({w_hh.dtype}, {b}, {h}) is per_step")
    h_a = torch.zeros((b, h), dtype=torch.float32, device=dev)
    h_b = None if return_hs else torch.empty_like(h_a)
    rc = lib.gru_scan_fwd(
        xp.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(), qlen.data_ptr(),
        h_a.data_ptr(), None if h_b is None else h_b.data_ptr(),
        None if hs is None else hs.data_ptr(), t, b, h,
        _DTYPE_CODE[w_hh.dtype], stream)
    _build.check(rc, "gru_scan_fwd")
    gru_scan.launches += t  # one kernel launch per time step
    if return_hs:
        return hs[-1], hs, hs.to(torch.bfloat16) if bf16 else None
    return h_a if t % 2 == 0 else h_b


_build.counted(gru_scan)


def _check_sweep_inputs(xp, w_hh, b_hh, qlen, hs, gh_final, hp):
    """(T, B, H, kernel): the checks of the recurrence's inputs, then of
    the sweep's own: hs and gh_final float32, and hp, (T, B, 3H) float32,
    exactly where ``sweep_kernel`` picks the persistent sweep (the
    per-step sweep recomputes it)."""
    t, b, h = _check_cuda_inputs(xp, w_hh, b_hh, qlen)
    dev = xp.device
    kernel = sweep_kernel(w_hh.dtype, b, h)
    named = [("hs", hs), ("gh_final", gh_final)]
    if kernel == "persistent":
        if hp is None:
            raise ValueError("the persistent sweep reads the forward's hp: "
                             "pass gru_scan(..., return_hp=True)'s")
        named.append(("hp", hp))
    elif hp is not None:
        raise ValueError("the per-step sweep recomputes hp; pass hp=None")
    for name, x in named:
        if x.device != dev or x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(hs.shape) != (t, b, h) or tuple(gh_final.shape) != (b, h):
        raise ValueError("hs must be (T, B, H) and gh_final (B, H)")
    if hp is not None and tuple(hp.shape) != (t, b, 3 * h):
        raise ValueError(f"hp must be {(t, b, 3 * h)}, got {tuple(hp.shape)}")
    return t, b, h, kernel


def gru_scan_bwd(xp: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                 qlen: torch.Tensor, hs: torch.Tensor,
                 gh_final: torch.Tensor, hp: torch.Tensor | None = None):
    """Reverse sweep over the saved states hs (T, B, H) float32 from the
    final state's gradient gh_final (B, H) float32: (dxp (T, B, 3H)
    float32, dhp (T, B, 3H) in W's dtype), as
    ``gru_scan_sweep_reference`` returns them. ``hp`` (T, B, 3H) float32
    is the forward's (``gru_scan(..., return_hp=True)``): the persistent
    sweep needs it, the per-step one takes none."""
    if xp.device.type == "cpu":
        return gru_scan_sweep_reference(xp, w_hh, b_hh, qlen, hs, gh_final,
                                        hp)
    t, b, h, kernel = _check_sweep_inputs(xp, w_hh, b_hh, qlen, hs,
                                          gh_final, hp)
    dev = xp.device
    lib = _build.load("gru_scan_bwd")
    dxp = torch.empty_like(xp)
    dhp = torch.empty(xp.shape, dtype=w_hh.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kernel == "persistent":
        counter = torch.empty((1,), dtype=torch.int32, device=dev)
        rc = lib.gru_scan_bwd_persistent(
            xp.data_ptr(), w_hh.data_ptr(), hp.data_ptr(), hs.data_ptr(),
            qlen.data_ptr(), gh_final.data_ptr(), dxp.data_ptr(),
            dhp.data_ptr(), counter.data_ptr(), t, b, h, stream)
        _build.check(rc, "gru_scan_bwd_persistent")
        gru_scan_bwd.launches += 1  # one launch for all T steps
        return dxp, dhp
    w_t = w_hh.t().contiguous()            # columns of W as coalesced rows
    # carry: the gradient of h_out for the next step down, ping-ponged
    bufs = (torch.empty_like(gh_final), torch.empty_like(gh_final))
    c_in = gh_final
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


_build.counted(gru_scan_bwd)


def _check_wgrad_inputs(dhp: torch.Tensor, hs: torch.Tensor) -> str:
    """The kernel ``wgrad_kernel`` picks for dhp (T, B, 3H), after
    checking that hs (T, B, H) is the states it takes: bf16 (hs16) for
    "wgmma", float32 for "simt"."""
    if dhp.dtype not in _DTYPE_CODE:
        raise TypeError(f"dhp must be float32 or bfloat16, got {dhp.dtype}")
    if dhp.dim() != 3 or dhp.shape[-1] % 3:
        raise ValueError(f"dhp must be (T, B, 3H), got {tuple(dhp.shape)}")
    t, b, h3 = dhp.shape
    kernel = wgrad_kernel(dhp.dtype, h3 // 3)
    want = torch.bfloat16 if kernel == "wgmma" else torch.float32
    if hs.dtype != want:
        raise TypeError(f"the {kernel} weight gradient takes {want} states, "
                        f"got {hs.dtype}")
    if tuple(hs.shape) != (t, b, h3 // 3) or hs.device != dhp.device:
        raise ValueError(f"hs must be {(t, b, h3 // 3)} on {dhp.device}, "
                         f"got {tuple(hs.shape)} on {hs.device}")
    if not (dhp.is_contiguous() and hs.is_contiguous()):
        raise ValueError("dhp and hs must be contiguous")
    return kernel


def gru_wgrad(dhp: torch.Tensor, hs: torch.Tensor):
    """dW (3H, H) and db (3H,), float32, as ``gru_wgrad_reference``
    returns them, from dhp (T, B, 3H) and the forward's states hs
    (T, B, H): hs16 (bf16) where ``wgrad_kernel`` picks the wgmma
    product, else the float32 hs. One launch on CUDA tensors."""
    if dhp.device.type == "cpu":
        return gru_wgrad_reference(dhp, hs)
    kernel = _check_wgrad_inputs(dhp, hs)
    t, b, h3 = dhp.shape
    h = h3 // 3
    dw = torch.empty((h3, h), dtype=torch.float32, device=dhp.device)
    db = torch.empty((h3,), dtype=torch.float32, device=dhp.device)
    stream = torch.cuda.current_stream(dhp.device).cuda_stream
    if kernel == "wgmma":
        rc = _build.load("gru_wgrad").gru_wgrad_wgmma(
            dhp.data_ptr(), hs.data_ptr(), dw.data_ptr(), db.data_ptr(), t,
            b, h, stream)
        _build.check(rc, "gru_wgrad_wgmma")
    else:
        rc = _build.load("gru_scan_bwd").gru_wgrad(
            dhp.data_ptr(), hs.data_ptr(), dw.data_ptr(), db.data_ptr(), t,
            b, h, _DTYPE_CODE[dhp.dtype], stream)
        _build.check(rc, "gru_wgrad")
    gru_wgrad.launches += 1
    return dw, db


_build.counted(gru_wgrad)


class GRUScanFunction(torch.autograd.Function):
    """Autograd of the recurrence: the forward keeps every step's state,
    the backward is the reverse sweep over them with no forward
    recompute beyond each step's gates. Gradients flow to xp, w_hh and
    b_hh (in their own dtypes); qlen has none."""

    @staticmethod
    def forward(ctx, xp, w_hh, b_hh, qlen):
        # the persistent sweep reads the forward's hp instead of
        # recomputing it
        keep_hp = sweep_kernel(w_hh.dtype, xp.shape[1],
                               w_hh.shape[1]) == "persistent"
        h_final, hs, hs16, *hp = gru_scan(xp, w_hh, b_hh, qlen,
                                          return_hs=True, return_hp=keep_hp)
        # the weight gradient's operand: hs16 for the wgmma product,
        # the float32 states for the SIMT reduction
        states = (hs16 if wgrad_kernel(w_hh.dtype, w_hh.shape[1]) == "wgmma"
                  else hs)
        ctx.save_for_backward(xp, w_hh, b_hh, qlen, hs, states, *hp)
        return h_final

    @staticmethod
    def backward(ctx, gh_final):
        xp, w_hh, b_hh, qlen, hs, states, *hp = ctx.saved_tensors
        dxp, dhp = gru_scan_bwd(xp, w_hh, b_hh, qlen, hs,
                                gh_final.float().contiguous(), *hp)
        dw, db = gru_wgrad(dhp, states)
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
