"""Inverted dropout, and the counter-based bits of the in-kernel dropout.

``dropout`` is the plain inverted dropout of the model's feature and
classifier layers (counterpart of flax ``nn.Dropout`` and of
``vqa_project_tpu/ops/dropout.py``). It draws from an explicit
``torch.Generator`` and keeps an element with probability exactly
``1 - rate``; the JAX package's default draws u8 bits instead, which
quantizes the keep rate to 1/256 (rate 0.4 keeps 154/256 = 0.6016).

``philox_keep`` is the plain version of the bits behind the graph
convolution's fused relu + dropout epilogue (``csrc/edge_aggregate.cu``):
Philox4x32-10 keyed by the image's int32 seed and counted by the
element's index within the image, so an element's mask depends on its
image and position and not on how the batch is cut. It is written in
torch integer ops and gives the kernel's bits exactly. The TPU kernel
draws from the TPU's own PRNG, whose bits no other device reproduces.
"""

from __future__ import annotations

from typing import Optional

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57      # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85      # Weyl key increments
_MASK32 = 0xFFFFFFFF
PHILOX_ROUNDS = 10


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout: each element is kept with probability
    ``1 - rate`` (a uniform draw >= rate) and scaled by 1/(1-rate) in
    x's dtype. ``rate`` 0 returns x unchanged. With ``out`` (x's shape
    and dtype, any strides, x itself allowed; nothing may require grad)
    the result is written there and out is returned, with the same
    draws and values."""
    if rate <= 0:
        return x if out is None or out is x else out.copy_(x)
    if not rate < 1:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    u = torch.rand(x.shape, generator=generator, device=x.device)
    # the scale as x's dtype holds it, passed as a number: no copy to the
    # card, so the step can be captured as a CUDA graph
    scale = float(torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype))
    return torch.where(u >= rate, x * scale, torch.zeros((), dtype=x.dtype,
                                                         device=x.device),
                       out=out)


def keep_threshold(rate: float) -> int:
    """The uint32 threshold of the epilogue: an element is kept when its
    32 random bits are >= this (the TPU kernel's rule,
    ``edge_aggregate.py:172-174``)."""
    return min(int(rate * 2.0 ** 32), 2 ** 32 - 1)


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of a * m for uint32 values held in int64,
    split so that no product leaves int64."""
    t_lo = a * (m & 0xFFFF)                       # < 2^48
    t_hi = a * (m >> 16)                          # < 2^48
    s = t_lo + ((t_hi & 0xFFFF) << 16)            # < 2^49
    return (t_hi >> 16) + (s >> 32), s & _MASK32


def philox4x32(ctr, key):
    """Philox4x32-10 on int64 tensors holding uint32 values: four counter
    words and two key words (broadcast together) -> four output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_bits(seeds: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """Word 0 of Philox4x32-10 with key (seed, 0) and counter
    (counter, 0, 0, 0), as int64 values in [0, 2^32).

    ``seeds`` and ``counter`` broadcast against each other; seeds are
    int32 and read as their uint32 bit pattern.
    """
    k0, c0 = torch.broadcast_tensors(seeds.to(torch.int64) & _MASK32,
                                     counter.to(torch.int64) & _MASK32)
    zero = torch.zeros_like(c0)
    return philox4x32((c0, zero, zero, zero), (k0, zero))[0]


def philox_keep(seeds: torch.Tensor, shape, rate: float) -> torch.Tensor:
    """(B, *shape) bool keep mask of the epilogue for per-image int32
    ``seeds`` (B,): element e of image b (row-major index within the
    image) is kept when philox_bits(seeds[b], e) >= keep_threshold."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, device=seeds.device, dtype=torch.int64)
    bits = philox_bits(seeds[:, None], idx[None, :])
    return (bits >= keep_threshold(rate)).reshape(seeds.shape[0], *shape)
