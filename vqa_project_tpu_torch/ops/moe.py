"""A mixture-of-experts layer's routing and its held experts' share.

Nemotron-H's MoE (``models/nemotron_h.py``): a float32 router over all
E routed experts picks each token's top k, and each expert is
``down(relu(up(x))^2)``. Under expert parallelism a card holds the
experts ``first .. first + held - 1``; this layer is told that range,
routes over all E and computes only its own experts' part of the
result, which is what goes on (the absent experts' part would come from
the cards that hold them).

- ``route``: sigmoid scores of the logits, the top k of the scores plus
  the fixed correction bias, the chosen scores normalized to sum 1 and
  times the routed scaling factor (DeepSeek-V3's rule, ``n_group`` 1).
- ``dispatch``: each pair of a live token and one of its k slots whose
  expert is held becomes one row; the rows are sorted by expert on the
  device, each expert's rows padded with zero rows to a multiple of
  ``ALIGN``, into a buffer of a static size (every pair held, plus the
  padding), with the per-expert offsets left on the device. No count
  reaches the host: no drops, no fixed capacity per expert, no sync, so
  a CUDA graph holds it whatever the routing. Pad tokens are routed to
  no expert.
- ``grouped_gemm``: the held experts' products in one launch each
  (``csrc/moe_grouped_gemm.cu``) on the card: forward, input gradient
  and weight gradient, bf16 operands and f32 sums, with the activation
  and its derivative in the epilogues. On CPU tensors its plain version,
  a loop over the experts (``grouped_gemm_reference``), as every
  wrapper of the port does. Its launch counter counts the kernel.
- ``held_experts``: the routed part of the layer's output, (T, H) f32,
  and the per-expert row counts (held + 1,) int32 whose last entry is
  the pairs that went to no held expert.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vqa_project_tpu_torch.config import device_guard
from vqa_project_tpu_torch.ops import _build

# each expert's rows start on a multiple of this: a whole row tile of the
# grouped product (csrc/moe_grouped_gemm.cu)
ALIGN = 128
_LAYOUTS = {"nt": 1, "nn": 0, "tn": 2}
_EPILOGUES = {"f32": 0, "relu2": 1, "dact": 2}


def route(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          top_k: int, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(experts (T, k) int64, weights (T, k) f32) of x (T, H) f32 under
    the router ``weight`` (E, H) f32 and correction ``bias`` (E,): the
    top k of sigmoid(x W^T) + bias; the weights are the chosen sigmoid
    scores over their sum (+ 1e-20) times ``scale``."""
    scores = torch.sigmoid(torch.matmul(x.float(), weight.float().t()))
    idx = torch.topk(scores.detach() + bias, top_k, dim=-1, sorted=True)[1]
    w = scores.gather(1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * scale
    return idx, w


def capacity(n_pairs: int, held: int) -> int:
    """Rows of the sorted buffer: every pair held, each expert padded."""
    return n_pairs + held * ALIGN


def dispatch(idx: torch.Tensor, w: torch.Tensor, live: torch.Tensor,
             first: int, held: int):
    """The sorted rows of the pairs (token, slot) of live tokens whose
    expert lies in [first, first + held), each expert's rows padded to a
    multiple of ALIGN. Returns (row_token (R,) int64: the token of each
    row, T for a padding or unused row; row_weight (R,) f32: its routing
    weight, 0 there; pair_row (T k,) int64: the row of each pair, R for
    a pair no held expert takes; offsets (held + 1,) int32: expert e's
    rows start at offsets[e]; counts (held + 1,) int32: each expert's
    pairs, and last those held by none), R = ``capacity``. Static
    shapes, no sync; nothing here is differentiated."""
    t, k = idx.shape
    dev = idx.device
    local = idx - first
    mine = live[:, None] & (local >= 0) & (local < held)
    # the bucket of every pair: its expert, or ``held`` for none here
    bucket = torch.where(mine, local, torch.full_like(local, held)).reshape(-1)
    counts = torch.zeros(held + 1, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, bucket, torch.ones_like(bucket))
    padded = (counts[:held] + ALIGN - 1) // ALIGN * ALIGN
    offsets = torch.zeros(held + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(padded, 0)
    starts = torch.zeros(held + 1, dtype=torch.int64, device=dev)
    starts[1:] = torch.cumsum(counts, 0)[:-1]
    order = torch.sort(bucket, stable=True)[1]
    sorted_bucket = bucket[order]
    rank = torch.arange(t * k, device=dev) - starts[sorted_bucket]
    cap = capacity(t * k, held)
    # a pair of no held expert goes to the row past the last, ``cap``
    dest = torch.where(sorted_bucket < held,
                       offsets[sorted_bucket.clamp(max=held - 1)] + rank,
                       torch.full_like(rank, cap))
    pair_row = torch.empty_like(dest)
    pair_row[order] = dest
    row_token = torch.full((cap + 1,), t, dtype=torch.int64, device=dev)
    row_token[dest] = order // k
    row_weight = torch.zeros(cap + 1, dtype=w.dtype, device=dev)
    row_weight[dest] = w.detach().reshape(-1)[order]
    return (row_token[:cap], row_weight[:cap], pair_row,
            offsets.to(torch.int32), counts.to(torch.int32))


def grouped_gemm_reference(a: torch.Tensor, b: torch.Tensor,
                           offsets: torch.Tensor, layout: str,
                           epilogue: str = "f32",
                           gate: Optional[torch.Tensor] = None):
    """The plain version of ``grouped_gemm``: a loop over the groups, the
    products summed in float32 (of bf16 operands exact in f32, the sum
    being the product's own); the epilogues' outputs in a's dtype."""
    off = offsets.tolist()
    groups = len(off) - 1
    if layout == "tn":
        out = a.new_zeros((groups, a.shape[1], b.shape[1]),
                          dtype=torch.float32)
    else:
        n = b.shape[1] if layout == "nt" else b.shape[2]
        out = a.new_zeros((a.shape[0], n), dtype=torch.float32)
    for e in range(groups):
        s, t = off[e], off[e + 1]
        if layout == "nt":
            out[s:t] = a[s:t].float() @ b[e].float().t()
        elif layout == "nn":
            out[s:t] = a[s:t].float() @ b[e].float()
        else:
            out[e] = a[s:t].float().t() @ b[s:t].float()
    if epilogue == "relu2":
        r = out.clamp(min=0)
        return (r * r).to(a.dtype), r.to(a.dtype)
    if epilogue == "dact":
        return (out * 2.0 * gate.float()).to(a.dtype), None
    return out, None


def grouped_gemm(a: torch.Tensor, b: torch.Tensor, offsets: torch.Tensor,
                 layout: str, epilogue: str = "f32",
                 gate: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The grouped product over the groups of rows ``offsets`` (G + 1,)
    int32 on a's device (see ``csrc/moe_grouped_gemm.cu``):

    - "nt": C[rows of e] = a[rows of e] b[e]^T, a (R, K), b (G, N, K);
    - "nn": C[rows of e] = a[rows of e] b[e], a (R, K), b (G, K, N);
    - "tn": C[e] = a[rows of e]^T b[rows of e], a (R, M), b (R, N).

    bf16 operands, f32 sums. Epilogues: "f32" stores C in float32;
    "relu2" ("nt") returns (bf16 relu(C)^2, bf16 relu(C)); "dact" ("nn")
    returns bf16 C * 2 ``gate``. Returns (C, the second output or None).
    On the card, rows of a and C past offsets[G] (and, for "nt" / "nn",
    nothing else) are left as they are; "tn" needs each group's rows
    padded to a multiple of 64 with zero rows. CPU tensors take
    ``grouped_gemm_reference``."""
    if layout not in _LAYOUTS or epilogue not in _EPILOGUES:
        raise ValueError(f"layout {layout!r} / epilogue {epilogue!r}")
    if ((epilogue == "relu2" and layout != "nt")
            or (epilogue == "dact" and layout != "nn")):
        raise ValueError(f"epilogue {epilogue!r} does not take layout "
                         f"{layout!r}")
    if a.device.type == "cpu":
        return grouped_gemm_reference(a, b, offsets, layout, epilogue, gate)
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"grouped_gemm takes bfloat16 operands, got "
                        f"{a.dtype} and {b.dtype}")
    for name, t in (("a", a), ("b", b), ("offsets", offsets)):
        if not t.is_contiguous() or t.device != a.device:
            raise ValueError(f"{name} must be contiguous and on {a.device}")
    if offsets.dtype != torch.int32 or offsets.dim() != 1:
        raise TypeError("offsets: a (G + 1,) int32 tensor")
    groups = offsets.shape[0] - 1
    rows = a.shape[0]
    if layout == "tn":
        m, n, k = a.shape[1], b.shape[1], 0
        if b.shape[0] != rows:
            raise ValueError("tn: a and b need the same rows")
        out = torch.empty((groups, m, n), device=a.device,
                          dtype=torch.float32)
    else:
        if b.dim() != 3 or b.shape[0] != groups:
            raise ValueError(f"b: ({groups}, ., .) per group, got "
                             f"{tuple(b.shape)}")
        m = 0
        n, k = (b.shape[1], b.shape[2]) if layout == "nt" else (b.shape[2],
                                                                b.shape[1])
        if a.shape[1] != k:
            raise ValueError(f"inner sizes differ: {a.shape[1]} and {k}")
        out = torch.empty((rows, n), device=a.device,
                          dtype=torch.float32 if epilogue == "f32"
                          else torch.bfloat16)
    aux = (torch.empty((rows, n), device=a.device, dtype=torch.bfloat16)
           if epilogue == "relu2" else None)
    if epilogue == "dact":
        if (gate is None or gate.shape != (rows, n)
                or gate.dtype != torch.bfloat16 or not gate.is_contiguous()):
            raise ValueError("dact: gate (rows, N) contiguous bfloat16")
    bn = 256 if n >= 1024 else 128
    with device_guard(a.device):
        lib = _build.load("moe_grouped_gemm")
        rc = lib.moe_grouped_gemm(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if aux is None else aux.data_ptr(),
            None if gate is None else gate.data_ptr(), offsets.data_ptr(),
            groups, rows, m, n, k, _LAYOUTS[layout], _EPILOGUES[epilogue],
            bn, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "moe_grouped_gemm")
    grouped_gemm.launches += 1
    return out, aux


_build.counted(grouped_gemm)


def _pairs(y: torch.Tensor, pair_row: torch.Tensor) -> torch.Tensor:
    """(T k, H): each pair's row of y (R, H), 0 for a pair held by none
    (a gather, with no scatter: the rows' gradients are gathered the same
    way, so no row is summed into by many)."""
    rows = y.shape[0]
    mine = (pair_row < rows)[:, None]
    return torch.where(mine, y.index_select(0, pair_row.clamp(max=rows - 1)),
                       y.new_zeros(()))


class _Experts(torch.autograd.Function):
    """The held experts' part of the layer: each pair's row of x (T, H)
    gathered to its expert's sorted rows, y = relu(x W_up^T)^2 W_down^T
    per expert (operands in the compute dtype, f32 sums), and each
    token's pairs' y weighted by w (T, k) and summed. The backward
    rounds the cotangent of y to the operands' dtype, as ``ops.matmul``
    does, and gathers every row's gradient (no atomics: the unused rows
    all name one token). The buffer has a row for every pair, so it keeps
    little of it for the backward: not the gathered rows (gathered again
    from x) and y in the compute dtype (it only weights the routing
    weights' gradient)."""

    @staticmethod
    def _rows(x, row_token, cdt):
        return torch.cat([x.to(cdt), x.new_zeros((1, x.shape[1]), dtype=cdt)]
                         ).index_select(0, row_token)

    @staticmethod
    def forward(ctx, x, w, w_up, w_down, row_token, row_weight, pair_row,
                offsets, cdt):
        t, hid = x.shape
        xs = _Experts._rows(x, row_token, cdt)
        up, down = w_up.to(cdt), w_down.to(cdt)
        act, relu = grouped_gemm(xs, up, offsets, "nt", "relu2")
        del xs
        y, _ = grouped_gemm(act, down, offsets, "nt")
        out = (_pairs(y, pair_row).view(t, -1, hid) * w[..., None]).sum(1)
        ctx.cdt = cdt
        ctx.save_for_backward(x, up, down, offsets, act, relu, y.to(cdt), w,
                              row_token, row_weight, pair_row)
        return out

    @staticmethod
    def backward(ctx, dout):
        (x, up, down, offsets, act, relu, y, w, row_token, row_weight,
         pair_row) = ctx.saved_tensors
        t, hid = dout.shape
        dz = torch.cat([dout, dout.new_zeros((1, hid))])
        dy = (row_weight[:, None] * dz.index_select(0, row_token)).to(
            ctx.cdt)
        dw = (_pairs(y, pair_row).view(t, -1, hid).float()
              * dout[:, None]).sum(-1)
        xs = _Experts._rows(x, row_token, ctx.cdt)
        dh, _ = grouped_gemm(dy, down, offsets, "nn", "dact", relu)
        d_down, _ = grouped_gemm(dy, act, offsets, "tn")
        d_up, _ = grouped_gemm(dh, xs, offsets, "tn")
        dxs, _ = grouped_gemm(dh, up, offsets, "nn")
        dx = _pairs(dxs, pair_row).view(t, -1, hid).sum(1)
        return dx, dw, d_up, d_down, None, None, None, None, None


def held_experts(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                 live: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, first: int,
                 compute_dtype: torch.dtype = torch.bfloat16
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the held experts' part of the output (T, H) f32, the counts of
    ``dispatch``) for tokens x (T, H) f32 routed by ``route``'s (idx, w),
    ``live`` (T,) bool, experts ``w_up`` (held, I, H) and ``w_down``
    (held, H, I) f32 holding experts first .. first + held - 1, their
    products' operands in ``compute_dtype`` (bfloat16 on the card)."""
    row_token, row_weight, pair_row, offsets, counts = dispatch(
        idx, w, live, first, w_up.shape[0])
    out = _Experts.apply(x, w, w_up, w_down, row_token, row_weight,
                         pair_row, offsets, compute_dtype)
    return out, counts
