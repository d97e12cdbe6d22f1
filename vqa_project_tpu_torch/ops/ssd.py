"""Mamba-2's selective state-space scan in its chunked form (SSD).

Dao and Gu, "Transformers are SSMs" (arXiv:2405.21060), section 6 and
its ``ssd_minimal``: per head h (of H, in G groups sharing B and C) the
recurrence over positions t

    S_t = exp(dt_t A_h) S_{t-1} + dt_t x_t B_t^T,    y_t = S_t C_t

with S (P, N) from zero, is computed chunk by chunk: inside a chunk of
Q positions as one masked product (the "diagonal block")

    y_i = sum_{j <= i} (C_i . B_j) exp(a_{j+1} + .. + a_i) dt_j x_j,
    a = dt A,

and across chunks through each chunk's final state, carried by its
total decay (the "off-diagonal" part). A sequence no longer than a chunk
is one chunk of its own length, which is the same sum; the inter-chunk
part then vanishes.

The decays, the masks and the state run in float32; the three products
(C B^T, the masked scores times x, and the states' B^T x and C S) take
operands in the compute dtype and sum in float32 (``ops.matmul.bmm``),
as Mamba-2's chunk kernels round the decayed scores and the states to
the inputs' dtype before their dots. One code path on the CPU and the
card, differentiable by autograd, and captured in the train step's CUDA
graph (no host sync). ``D x`` is the caller's.
"""

from __future__ import annotations

import torch

from vqa_project_tpu_torch.ops.matmul import bmm


def segment_sums(cs: torch.Tensor) -> torch.Tensor:
    """(..., Q) inclusive cumulative sums -> (..., Q, Q): entry (i, j) is
    cs_i - cs_j, the sum of the terms j+1..i, for j <= i, and -inf
    above the diagonal (so that its exp is 0)."""
    q = cs.shape[-1]
    seg = cs[..., :, None] - cs[..., None, :]
    upper = torch.ones(q, q, dtype=torch.bool, device=cs.device).triu(1)
    return seg.masked_fill(upper, float("-inf"))


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        B: torch.Tensor, C: torch.Tensor, chunk: int,
        compute_dtype: torch.dtype) -> torch.Tensor:
    """y (b, L, H, P) float32 of the scan above, from x (b, L, H, P), dt
    (b, L, H) (already softplus-ed, 0 where a position must leave the
    state alone), A (H,) (negative), B and C (b, L, G, N), all float32;
    head h reads group h // (H / G)."""
    b, length, nh, p = x.shape
    g, n = B.shape[2:]
    r = nh // g
    q = length if length <= chunk else chunk
    nc = -(-length // q)
    pad = nc * q - length
    if pad:
        # zero dt and x: the padded tail neither adds to nor decays a state
        x, dt, B, C = (torch.nn.functional.pad(t, (0,) * (2 * (t.dim() - 2))
                                               + (0, pad))
                       for t in (x, dt, B, C))
    cdt = compute_dtype
    x = x.reshape(b, nc, q, nh, p)
    dt = dt.reshape(b, nc, q, nh)
    B = B.reshape(b, nc, q, g, n)
    C = C.reshape(b, nc, q, g, n)
    # (b, nc, H, Q): the log-decays and their running sums in each chunk
    a = (dt * A).permute(0, 1, 3, 2)
    cs = torch.cumsum(a, dim=-1)

    # the diagonal blocks: (C_i . B_j) per group, decayed per head
    cg = C.permute(0, 1, 3, 2, 4).reshape(b * nc * g, q, n)
    bg = B.permute(0, 1, 3, 2, 4).reshape(b * nc * g, q, n)
    cb = bmm(cg.to(cdt), bg.to(cdt).transpose(1, 2)).view(b, nc, g, 1, q, q)
    decay = torch.exp(segment_sums(cs)).view(b, nc, g, r, q, q)
    scores = cb * decay * dt.permute(0, 1, 3, 2).reshape(
        b, nc, g, r, 1, q)
    xh = x.permute(0, 1, 3, 2, 4).reshape(b * nc * nh, q, p)
    y = bmm(scores.reshape(b * nc * nh, q, q).to(cdt), xh.to(cdt)).view(
        b, nc, nh, q, p)

    if nc > 1:
        # each chunk's own final state (b, nc, H, P, N): its x_j dt_j
        # decayed to the chunk's end, times B_j
        tail = torch.exp(cs[..., -1:] - cs) * dt.permute(0, 1, 3, 2)
        xs = (xh.view(b, nc, nh, q, p) * tail[..., None]).reshape(
            b * nc * nh, q, p)
        bh = bg.view(b, nc, g, 1, q, n).expand(b, nc, g, r, q, n).reshape(
            b * nc * nh, q, n)
        own = bmm(xs.transpose(1, 2).to(cdt), bh.to(cdt)).view(
            b, nc, nh, p, n)
        # the state entering each chunk, carried across chunks in float32
        total = torch.exp(cs[..., -1])                      # (b, nc, H)
        state = torch.zeros_like(own[:, 0])
        entering = []
        for k in range(nc):
            entering.append(state)
            state = total[:, k, :, None, None] * state + own[:, k]
        prev = torch.stack(entering, dim=1)                 # (b, nc, H, P, N)
        ch = cg.view(b, nc, g, 1, q, n).expand(b, nc, g, r, q, n).reshape(
            b * nc * nh, q, n)
        off = bmm(ch.to(cdt), prev.reshape(b * nc * nh, p, n).transpose(
            1, 2).to(cdt)).view(b, nc, nh, q, p)
        y = y + off * torch.exp(cs)[..., None]

    y = y.permute(0, 1, 3, 2, 4).reshape(b, nc * q, nh, p)
    return y[:, :length]
