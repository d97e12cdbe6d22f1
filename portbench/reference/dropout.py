"""The dropout masks of a training step, worked out from its seed.

The model draws them from one ``torch.Generator``, in this order: a
uniform per element of the nodes (kept where u >= rate), one int32 seed
per image for conv1's dropout, and a uniform per element after the
classifier's first layer. Conv1's mask is counter-based: element e of
image b (row-major within the image) is kept where word 0 of
Philox4x32-10, keyed (seed_b, 0) and counted (e, 0, 0, 0), is at least
rate * 2^32. Kept elements are scaled by 1 / (1 - rate).

The same draws from a generator seeded alike, on the same device, give
the same bits; Philox is written out here from its definition (Salmon
et al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011).
"""

from __future__ import annotations

import dataclasses

import torch

_MUL = (0xD2511F53, 0xCD9E8D57)
_WEYL = (0x9E3779B9, 0xBB67AE85)
_LO32 = 0xFFFFFFFF


@dataclasses.dataclass
class Draws:
    rate: float
    u_nodes: torch.Tensor     # (B, K, F) float32
    seeds: torch.Tensor       # (B,) int32
    u_out: torch.Tensor       # (B, out) float32

    def apply(self, x, u):
        return torch.where(u >= self.rate, x / (1.0 - self.rate),
                           torch.zeros_like(x))


def draw(generator: torch.Generator, b: int, k: int, f: int, n_out: int,
         rate: float, device) -> Draws:
    u_nodes = torch.rand((b, k, f), generator=generator, device=device)
    seeds = torch.randint(0, 2 ** 31 - 1, (b,), generator=generator,
                          device=device, dtype=torch.int32)
    u_out = torch.rand((b, n_out), generator=generator, device=device)
    return Draws(rate, u_nodes, seeds, u_out)


def _mul32(a: torch.Tensor, m: int):
    """(high, low) 32-bit words of a * m, a < 2^32 held in int64."""
    lo16, hi16 = m & 0xFFFF, m >> 16
    p_lo = a * lo16
    p_hi = a * hi16
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & _LO32


def philox_word0(key: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """Word 0 of Philox4x32-10 with key (key, 0) and counter
    (counter, 0, 0, 0), in int64."""
    k0, c0 = torch.broadcast_tensors(key.long() & _LO32,
                                     counter.long() & _LO32)
    k1 = torch.zeros_like(k0)
    c1 = torch.zeros_like(c0)
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    for rnd in range(10):
        if rnd:
            k0 = (k0 + _WEYL[0]) & _LO32
            k1 = (k1 + _WEYL[1]) & _LO32
        hi0, lo0 = _mul32(c0, _MUL[0])
        hi1, lo1 = _mul32(c2, _MUL[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def philox_keep(seeds: torch.Tensor, shape, rate: float) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= int(s)
    e = torch.arange(n, device=seeds.device)
    bits = philox_word0(seeds[:, None], e[None, :])
    thr = min(int(rate * 2.0 ** 32), 2 ** 32 - 1)
    return (bits >= thr).reshape(seeds.shape[0], *shape)
