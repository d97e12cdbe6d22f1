"""Fused Gaussian-weight neighbourhood aggregation (graph-conv tail).

Counterpart of ``vqa_project_tpu/ops/pallas/edge_aggregate.py::
fused_sel_aggregate_act``, forward and hand-derived backward. Three
kernels of ``csrc/`` serve CUDA tensors, each beside its plain PyTorch
version, which serves CPU tensors:

- A, ``csrc/edge_aggregate.cu::edge_aggregate_fwd``: the inference
  forward (``sel_aggregate_act_reference``);
- C, ``edge_aggregate_fwd_res``: the training forward, which also saves
  the normalized Gaussians ghat and their denominator, with the relu and
  inverted-dropout epilogue (``sel_aggregate_act_residuals_reference``);
- D, ``csrc/edge_aggregate_bwd.cu::edge_aggregate_bwd``: the VJP of C
  from those residuals (``sel_aggregate_act_vjp_reference``).

``EdgeAggregateFunction`` joins C and D for autograd;
``fused_sel_aggregate_act`` takes it whenever a gradient is wanted or
dropout is on, and kernel A otherwise. Each kernel has two bodies, picked
by ``aggregate_kernel``: the bf16 tensor-core body ("mma") and the SIMT
body ("simt", f32 above all).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from vqa_project_tpu_torch.ops import _build
from vqa_project_tpu_torch.ops.dropout import keep_threshold, philox_keep
from vqa_project_tpu_torch.ops.gaussian import (gaussian_kernel_terms,
                                                gaussian_kernel_weights)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BODY_CODE = {"simt": 0, "mma": 1}


def aggregate_kernel(dtype: torch.dtype, k: int, n: int, d: int) -> str:
    """Which body kernels A, C and D run for proj of ``dtype`` with K
    nodes, n Gaussian kernels and d columns a kernel, on the card.

    "mma" (the products on mma.sync.m16n8k16, bf16 operands and f32 sums,
    the weights split into a bf16 high and low part; one block per image
    and Gaussian kernel) for bf16 with K <= 64 (rows padded to a multiple
    of 16) and rows of d bf16 a multiple of 16 bytes (cp.async copies).
    "simt" (every product in f32 on the SIMT cores) for everything else,
    f32 above all: its sums stay exact f32. n plays no part: both bodies
    take up to 32 kernels.
    """
    del n
    if dtype == torch.bfloat16 and k <= 64 and (d * 2) % 16 == 0:
        return "mma"
    return "simt"


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t itself when its data starts on 16 bytes (the mma bodies'
    cp.async copies and bf16x2 stores need 16 or 8), else an aligned
    copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def sel_aggregate_act_reference(sel: torch.Tensor, pseudo: torch.Tensor,
                                proj: torch.Tensor, gparams: torch.Tensor,
                                relu: bool = False) -> torch.Tensor:
    """Plain version: Gaussian kernel weights times ``sel``, aggregated
    over neighbours per kernel in float32, then relu, in ``proj.dtype``.

    Args:
      sel:     (B, K, K) selected edge weights (alpha or the 0/1 mask).
      pseudo:  (B, K, K, 2) polar pseudo-coordinates.
      proj:    (B, K, n*d) per-kernel projected node features; column
               block n*d:(n+1)*d is kernel n.
      gparams: (4, n) [mu_rho; mu_theta; prec_rho; prec_theta].
    Returns: (B, K, n*d) in proj.dtype.
    """
    n_kernels = gparams.shape[1]
    b, k, nd = proj.shape
    gw = gaussian_kernel_weights(pseudo, gparams[0], gparams[1],
                                 gparams[2], gparams[3])   # (B, K, K, n)
    edge_w = gw * sel.float()[..., None]
    proj4 = proj.float().reshape(b, k, n_kernels, nd // n_kernels)
    out = torch.einsum("bijn,bjnd->bind", edge_w, proj4).reshape(b, k, nd)
    if relu:
        out = torch.relu(out)
    return out.to(proj.dtype)


def _epilogue(acc: torch.Tensor, relu: bool, dropout_rate: float,
              seeds: Optional[torch.Tensor]) -> torch.Tensor:
    """relu, then inverted dropout from the per-image Philox bits, on the
    float32 sums (dropout implies relu)."""
    if relu or dropout_rate > 0:
        acc = torch.relu(acc)
    if dropout_rate > 0:
        if seeds is None:
            raise ValueError("in-kernel dropout needs per-image seeds (B,)")
        keep = philox_keep(seeds, acc.shape[1:], dropout_rate)
        acc = torch.where(keep, acc * (1.0 / (1.0 - dropout_rate)),
                          torch.zeros_like(acc))
    return acc


def sel_aggregate_act_residuals_reference(
        sel: torch.Tensor, pseudo: torch.Tensor, proj: torch.Tensor,
        gparams: torch.Tensor, relu: bool = False, dropout_rate: float = 0.0,
        seeds: Optional[torch.Tensor] = None):
    """Plain version of kernel C: (out, ghat, denom).

    out is ``sel_aggregate_act_reference`` with the relu + dropout
    epilogue (``seeds`` (B,) int32 per image, needed when dropout_rate >
    0); ghat (B, n, K, K) float32 are the normalized Gaussian weights and
    denom (B, K, K) float32 their clamped denominator, the residuals the
    backward reads.
    """
    n_kernels = gparams.shape[1]
    b, k, nd = proj.shape
    w, denom = gaussian_kernel_terms(pseudo, gparams[0], gparams[1],
                                     gparams[2], gparams[3])
    ghat = (w / denom).permute(0, 3, 1, 2)                # (B, n, K, K)
    edge_w = sel.float()[:, None] * ghat
    proj4 = proj.float().reshape(b, k, n_kernels, nd // n_kernels)
    acc = torch.einsum("bnij,bjnd->bind", edge_w, proj4).reshape(b, k, nd)
    out = _epilogue(acc, relu, dropout_rate, seeds)
    return out.to(proj.dtype), ghat.contiguous(), denom[..., 0].contiguous()


def sel_aggregate_act_vjp_reference(
        g: torch.Tensor, sel: torch.Tensor, ghat: torch.Tensor,
        denom: torch.Tensor, pseudo: torch.Tensor, proj: torch.Tensor,
        gparams: torch.Tensor, out: Optional[torch.Tensor] = None,
        dropout_rate: float = 0.0):
    """Plain version of kernel D: the hand-derived VJP of kernel C.

    g is the cotangent of out; ``out`` is given when an epilogue (relu,
    dropout) ran, and then out > 0 marks the units whose gradient passes,
    scaled by 1/(1-rate). The terms are those of the TPU kernel's
    docstring (``edge_aggregate.py:288-301``), all in float32. Returns
    (dsel (B, K, K), dpseudo (B, K, K, 2), dproj in proj's dtype,
    dgparams (4, n)).
    """
    n_kernels = gparams.shape[1]
    b, k, nd = proj.shape
    d = nd // n_kernels
    gf = g.float()
    if out is not None:
        inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0 else 1.0
        gf = torch.where(out.float() > 0, gf * inv_keep,
                         torch.zeros_like(gf))
    g4 = gf.reshape(b, k, n_kernels, d)
    p4 = proj.float().reshape(b, k, n_kernels, d)
    sel = sel.float()
    w_edge = sel[:, None] * ghat                          # (B, n, K, K)
    dproj = torch.einsum("bnij,bind->bjnd", w_edge, g4).reshape(b, k, nd)
    ge = torch.einsum("bind,bjnd->bnij", g4, p4)          # G_n
    dsel = (ge * ghat).sum(dim=1)
    dgw = ge * sel[:, None]
    s_cross = (dgw * ghat).sum(dim=1, keepdim=True)
    den = denom[:, None]
    ind = (den > 1e-20).float()
    dwn_wn = ((dgw - ind * s_cross) / den) * (ghat * den)  # dw_n * w_n

    mu_r, mu_t, pr, pt = (gparams[i].float().reshape(1, n_kernels, 1, 1)
                          for i in range(4))
    rho = pseudo[..., 0].float()[:, None]
    theta = pseudo[..., 1].float()[:, None]
    inv_r = 1.0 / (1e-14 + pr * pr)
    inv_t = 1.0 / (1e-14 + pt * pt)
    x_r = rho - mu_r
    drho = (dwn_wn * (-x_r * inv_r)).sum(dim=1)
    dmu_r = (dwn_wn * x_r * inv_r).sum(dim=(0, 2, 3))
    dpr = (dwn_wn * (x_r * x_r) * pr * inv_r * inv_r).sum(dim=(0, 2, 3))
    two_pi = 2.0 * math.pi
    first = torch.abs(theta - mu_t)
    second = torch.abs(two_pi - first)
    dist = torch.minimum(first, second)
    # dD/dfirst: 1 on the first branch (ties go to it, as jnp.minimum
    # routes them), -sign(2 pi - first) on the second; sign(0) = 0
    dd_dfirst = torch.where(first <= second, torch.ones_like(first),
                            -torch.sign(two_pi - first))
    common_t = (dwn_wn * (-dist * inv_t) * dd_dfirst
                * torch.sign(theta - mu_t))
    dtheta = common_t.sum(dim=1)
    dmu_t = (-common_t).sum(dim=(0, 2, 3))
    dpt = (dwn_wn * (dist * dist) * pt * inv_t * inv_t).sum(dim=(0, 2, 3))
    dpseudo = torch.stack([drho, dtheta], dim=-1)
    dgparams = torch.stack([dmu_r, dmu_t, dpr, dpt])
    return dsel, dpseudo, dproj.to(proj.dtype), dgparams


def _check_cuda_inputs(sel, pseudo, proj, gparams):
    dev = proj.device
    for name, t in (("sel", sel), ("pseudo", pseudo), ("gparams", gparams)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, proj on {dev}")
    if proj.dtype not in _DTYPE_CODE:
        raise TypeError(f"proj must be float32 or bfloat16, got {proj.dtype}")
    for name, t in (("sel", sel), ("pseudo", pseudo), ("gparams", gparams)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if proj.dim() != 3:
        raise ValueError(f"proj must be (B, K, n*d), got {tuple(proj.shape)}")
    b, k, nd = proj.shape
    if gparams.dim() != 2 or gparams.shape[0] != 4:
        raise ValueError(f"gparams must be (4, n), got {tuple(gparams.shape)}")
    n_kernels = gparams.shape[1]
    if nd % n_kernels:
        raise ValueError(f"proj width {nd} is not a multiple of n={n_kernels}")
    if tuple(sel.shape) != (b, k, k):
        raise ValueError(f"sel must be {(b, k, k)}, got {tuple(sel.shape)}")
    if tuple(pseudo.shape) != (b, k, k, 2):
        raise ValueError(
            f"pseudo must be {(b, k, k, 2)}, got {tuple(pseudo.shape)}")
    for name, t in (("sel", sel), ("pseudo", pseudo), ("proj", proj),
                    ("gparams", gparams)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return b, k, n_kernels, nd // n_kernels


def _check_like(name: str, t: torch.Tensor, shape, dtype, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, proj on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_dropout(dropout_rate: float, seeds, b: int, dev) -> None:
    if dropout_rate <= 0:
        return
    if not dropout_rate < 1:
        raise ValueError(f"dropout rate must be in [0, 1), got "
                         f"{dropout_rate}")
    if seeds is None:
        raise ValueError("in-kernel dropout needs per-image seeds (B,)")
    _check_like("seeds", seeds, (b,), torch.int32, dev)


def fused_sel_aggregate_act(sel: torch.Tensor, pseudo: torch.Tensor,
                            proj: torch.Tensor, gparams: torch.Tensor,
                            relu: bool = False,
                            dropout_rate: float = 0.0,
                            seeds: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Aggregation over pre-selected edge weights with an optional relu
    and, with ``dropout_rate`` > 0, inverted dropout from per-image int32
    ``seeds`` (B,) after it.

    Same layout as the JAX entry: sel (B, K, K) f32, pseudo (B, K, K, 2)
    f32, proj (B, K, n*d) in the compute dtype, gparams (4, n) f32;
    returns (B, K, n*d) in proj.dtype. Differentiable in sel, pseudo,
    proj and gparams (kernels C and D); without a gradient to record and
    without dropout it runs kernel A.
    """
    wants_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (sel, pseudo, proj, gparams))
    if wants_grad or dropout_rate > 0:
        return EdgeAggregateFunction.apply(sel, pseudo, proj, gparams, seeds,
                                           relu, dropout_rate)
    if proj.device.type == "cpu":
        return sel_aggregate_act_reference(sel, pseudo, proj, gparams, relu)
    b, k, n_kernels, d = _check_cuda_inputs(sel, pseudo, proj, gparams)
    body = aggregate_kernel(proj.dtype, k, n_kernels, d)
    if body == "mma":
        sel, pseudo, proj = (_aligned16(t) for t in (sel, pseudo, proj))
    lib = _build.load("edge_aggregate")
    out = torch.empty_like(proj)
    # the mma body's Gaussians, evaluated once before the product
    ghat = (torch.empty((b, n_kernels, k, k), dtype=torch.float32,
                        device=proj.device) if body == "mma" else None)
    stream = torch.cuda.current_stream(proj.device).cuda_stream
    rc = lib.edge_aggregate_fwd(
        sel.data_ptr(), pseudo.data_ptr(), proj.data_ptr(),
        gparams.data_ptr(), out.data_ptr(),
        ghat.data_ptr() if ghat is not None else None, b, k, n_kernels, d,
        int(bool(relu)), _DTYPE_CODE[proj.dtype], _BODY_CODE[body], stream)
    _build.check(rc, "edge_aggregate_fwd")
    fused_sel_aggregate_act.launches += 1
    return out


_build.counted(fused_sel_aggregate_act)


def sel_aggregate_act_residuals(sel: torch.Tensor, pseudo: torch.Tensor,
                                proj: torch.Tensor, gparams: torch.Tensor,
                                relu: bool = False, dropout_rate: float = 0.0,
                                seeds: Optional[torch.Tensor] = None):
    """Training forward (kernel C on CUDA tensors): (out, ghat, denom) as
    ``sel_aggregate_act_residuals_reference`` returns them."""
    if proj.device.type == "cpu":
        return sel_aggregate_act_residuals_reference(
            sel, pseudo, proj, gparams, relu, dropout_rate, seeds)
    b, k, n_kernels, d = _check_cuda_inputs(sel, pseudo, proj, gparams)
    _check_dropout(dropout_rate, seeds, b, proj.device)
    body = aggregate_kernel(proj.dtype, k, n_kernels, d)
    if body == "mma":
        sel, pseudo, proj = (_aligned16(t) for t in (sel, pseudo, proj))
    lib = _build.load("edge_aggregate")
    out = torch.empty_like(proj)
    ghat = torch.empty((b, n_kernels, k, k), dtype=torch.float32,
                       device=proj.device)
    denom = torch.empty((b, k, k), dtype=torch.float32, device=proj.device)
    drop = dropout_rate > 0
    stream = torch.cuda.current_stream(proj.device).cuda_stream
    rc = lib.edge_aggregate_fwd_res(
        sel.data_ptr(), pseudo.data_ptr(), proj.data_ptr(),
        gparams.data_ptr(), seeds.data_ptr() if drop else None,
        out.data_ptr(), ghat.data_ptr(), denom.data_ptr(), b, k, n_kernels,
        d, int(bool(relu)), keep_threshold(dropout_rate) if drop else 0,
        1.0 / (1.0 - dropout_rate) if drop else 1.0,
        _DTYPE_CODE[proj.dtype], _BODY_CODE[body], stream)
    _build.check(rc, "edge_aggregate_fwd_res")
    sel_aggregate_act_residuals.launches += 1
    return out, ghat, denom


_build.counted(sel_aggregate_act_residuals)


def sel_aggregate_act_vjp(g: torch.Tensor, sel: torch.Tensor,
                          ghat: torch.Tensor, denom: torch.Tensor,
                          pseudo: torch.Tensor, proj: torch.Tensor,
                          gparams: torch.Tensor,
                          out: Optional[torch.Tensor] = None,
                          dropout_rate: float = 0.0):
    """Backward (kernel D on CUDA tensors): (dsel, dpseudo, dproj,
    dgparams) as ``sel_aggregate_act_vjp_reference`` returns them."""
    if proj.device.type == "cpu":
        return sel_aggregate_act_vjp_reference(
            g, sel, ghat, denom, pseudo, proj, gparams, out, dropout_rate)
    b, k, n_kernels, d = _check_cuda_inputs(sel, pseudo, proj, gparams)
    dev = proj.device
    if k * k > 64 * 64:
        raise ValueError(f"the backward kernel needs K <= 64, got K={k}")
    _check_like("g", g, proj.shape, proj.dtype, dev)
    _check_like("ghat", ghat, (b, n_kernels, k, k), torch.float32, dev)
    _check_like("denom", denom, (b, k, k), torch.float32, dev)
    if out is not None:
        _check_like("out", out, proj.shape, proj.dtype, dev)
    body = aggregate_kernel(proj.dtype, k, n_kernels, d)
    if body == "mma":
        g, proj = _aligned16(g), _aligned16(proj)
        out = _aligned16(out) if out is not None else None
    lib = _build.load("edge_aggregate_bwd")
    f32 = dict(dtype=torch.float32, device=dev)
    ge = torch.empty((b, n_kernels, k, k), **f32)
    dsel = torch.empty((b, k, k), **f32)
    dpseudo = torch.empty((b, k, k, 2), **f32)
    dproj = torch.empty_like(proj)
    tiles = lib.edge_aggregate_bwd_tiles(k)
    dgp_part = torch.empty((b * tiles, 4, n_kernels), **f32)
    inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0 else 1.0
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.edge_aggregate_bwd(
        g.data_ptr(), sel.data_ptr(), ghat.data_ptr(), denom.data_ptr(),
        pseudo.data_ptr(), proj.data_ptr(), gparams.data_ptr(),
        out.data_ptr() if out is not None else None, ge.data_ptr(),
        dsel.data_ptr(), dpseudo.data_ptr(), dproj.data_ptr(),
        dgp_part.data_ptr(), b, k, n_kernels, d, inv_keep,
        _DTYPE_CODE[proj.dtype], _BODY_CODE[body], stream)
    _build.check(rc, "edge_aggregate_bwd")
    sel_aggregate_act_vjp.launches += 1
    # the per-block partials, summed in a fixed order (no atomics)
    return dsel, dpseudo, dproj, dgp_part.sum(dim=0)


_build.counted(sel_aggregate_act_vjp)


class EdgeAggregateFunction(torch.autograd.Function):
    """Autograd of the fused aggregation: the forward saves ghat and
    denom (kernel C), the backward computes every gradient from them
    (kernel D) with no forward recompute."""

    @staticmethod
    def forward(ctx, sel, pseudo, proj, gparams, seeds, relu, dropout_rate):
        out, ghat, denom = sel_aggregate_act_residuals(
            sel, pseudo, proj, gparams, relu, dropout_rate, seeds)
        epilogue = relu or dropout_rate > 0
        ctx.dropout_rate = dropout_rate
        ctx.epilogue = epilogue
        ctx.save_for_backward(sel, ghat, denom, pseudo, proj, gparams,
                              out if epilogue else None)
        return out

    @staticmethod
    def backward(ctx, g):
        sel, ghat, denom, pseudo, proj, gparams, out = ctx.saved_tensors
        dsel, dpseudo, dproj, dgparams = sel_aggregate_act_vjp(
            g.contiguous(), sel, ghat, denom, pseudo, proj, gparams,
            out if ctx.epilogue else None, ctx.dropout_rate)
        return dsel, dpseudo, dproj, dgparams, None, None, None
