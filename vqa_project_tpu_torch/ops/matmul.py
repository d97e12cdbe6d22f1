"""Matrix products under the compute-dtype policy.

The JAX package asks XLA for ``preferred_element_type``: operands in the
compute dtype, products accumulated in float32, and the result stored
in a chosen dtype. ``matmul`` is that contract for torch. These are the
large plain products the JAX package also leaves outside its kernels
(GRU input projection, weight-norm layers, conv projection, A = E E^T).
``bmm`` is the same contract for batched products (MCAN's attention).
"""

from __future__ import annotations

import torch


def _mm(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype):
    """cuBLAS accumulates bf16 products in f32; asking for an f32 result
    keeps the sum unrounded, as XLA's preferred_element_type does."""
    if out_dtype == torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a, b).to(out_dtype)


class _CudaMatmul(torch.autograd.Function):
    """(M, k) x (k, n) with bf16 operands on CUDA, the sum in float32,
    stored in ``out_dtype``. ``torch.mm(..., out_dtype=)`` records no
    gradient, so the backward is written here and keeps the contract:
    the cotangent is rounded to the operands' dtype and each product
    sums in float32 before it is stored in that dtype."""

    @staticmethod
    def forward(ctx, a, b, out_dtype):
        ctx.save_for_backward(a, b)
        return _mm(a, b, out_dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = _mm(g, b.t(), a.dtype) if ctx.needs_input_grad[0] else None
        db = _mm(a.t(), g, b.dtype) if ctx.needs_input_grad[1] else None
        return da, db, None


def matmul(a: torch.Tensor, b: torch.Tensor,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``a @ b`` for a (..., k) and b (k, n) of one dtype, accumulated in
    float32 and returned in ``out_dtype``; differentiable."""
    if a.dtype != b.dtype:
        raise TypeError(f"operand dtypes differ: {a.dtype} vs {b.dtype}")
    if a.dtype == torch.float32:
        return torch.matmul(a, b).to(out_dtype)
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    if a.is_cuda:
        wants_grad = torch.is_grad_enabled() and (a.requires_grad
                                                  or b.requires_grad)
        y = (_CudaMatmul.apply(a2, b, out_dtype) if wants_grad
             else _mm(a2, b, out_dtype))
    else:
        # bf16 x bf16 products are exact in f32, so this is the same sum
        y = torch.mm(a2.float(), b.float()).to(out_dtype)
    return y.reshape(*lead, b.shape[-1])


def _bmm(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype):
    if out_dtype == torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a, b).to(out_dtype)


class _CudaBmm(torch.autograd.Function):
    """``_CudaMatmul`` for (n, M, k) x (n, k, m)."""

    @staticmethod
    def forward(ctx, a, b, out_dtype):
        ctx.save_for_backward(a, b)
        return _bmm(a, b, out_dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = (_bmm(g, b.transpose(1, 2), a.dtype)
              if ctx.needs_input_grad[0] else None)
        db = (_bmm(a.transpose(1, 2), g, b.dtype)
              if ctx.needs_input_grad[1] else None)
        return da, db, None


def bmm(a: torch.Tensor, b: torch.Tensor,
        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``a @ b`` for a (..., M, k) and b (..., k, m) of one dtype and the
    same leading shape, accumulated in float32 and returned in
    ``out_dtype``; differentiable."""
    if a.dtype != b.dtype:
        raise TypeError(f"operand dtypes differ: {a.dtype} vs {b.dtype}")
    lead = a.shape[:-2]
    if a.dtype == torch.float32:
        return torch.matmul(a, b).to(out_dtype)
    a3 = a.reshape(-1, *a.shape[-2:])
    b3 = b.reshape(-1, *b.shape[-2:])
    if a.is_cuda:
        wants_grad = torch.is_grad_enabled() and (a.requires_grad
                                                  or b.requires_grad)
        y = (_CudaBmm.apply(a3, b3, out_dtype) if wants_grad
             else _bmm(a3, b3, out_dtype))
    else:
        y = torch.bmm(a3.float(), b3.float()).to(out_dtype)
    return y.reshape(*lead, *y.shape[-2:])
