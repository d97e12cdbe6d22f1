"""Matrix products under the compute-dtype policy.

The JAX package asks XLA for ``preferred_element_type``: operands in the
compute dtype, products accumulated in float32, and the result stored
in a chosen dtype. ``matmul`` is that contract for torch. These are the
large plain products the JAX package also leaves outside its kernels
(GRU input projection, weight-norm layers, conv projection, A = E E^T).
"""

from __future__ import annotations

import torch


def matmul(a: torch.Tensor, b: torch.Tensor,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``a @ b`` for a (..., k) and b (k, n) of one dtype, accumulated in
    float32 and returned in ``out_dtype``."""
    if a.dtype != b.dtype:
        raise TypeError(f"operand dtypes differ: {a.dtype} vs {b.dtype}")
    if a.dtype == torch.float32:
        return torch.matmul(a, b).to(out_dtype)
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    if a.is_cuda:
        # cuBLAS accumulates bf16 products in f32; out_dtype=f32 keeps
        # the sum unrounded, as XLA's preferred_element_type does
        if out_dtype == torch.float32:
            y = torch.mm(a2, b, out_dtype=torch.float32)
        else:
            y = torch.mm(a2, b).to(out_dtype)
    else:
        # bf16 x bf16 products are exact in f32, so this is the same sum
        y = torch.mm(a2.float(), b.float()).to(out_dtype)
    return y.reshape(*lead, b.shape[-1])
