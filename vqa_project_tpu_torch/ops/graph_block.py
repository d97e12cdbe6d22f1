"""The merged graph block: both graph convolutions and their projections
in one call per direction.

Counterpart of ``vqa_project_tpu/ops/pallas/graph_block.py::
fused_graph_block``:

    relu(conv2(mask, dropout(relu(conv1(alpha, feats @ W1))) @ W2))

with the top-m neighbourhood (mask, and alpha its softmax) selected
from the raw adjacency inside the block. Two kernels of ``csrc/`` serve
CUDA tensors, each beside its plain PyTorch version, which serves CPU
tensors:

- H, ``csrc/graph_block.cu::graph_block_fwd`` (``graph_block_fwd``):
  the forward, saving what the backward reads, projections included;
- I, ``csrc/graph_block_bwd.cu::graph_block_bwd`` (``graph_block_bwd``):
  its hand-derived VJP.

Both run each product whose operands are bf16 with rows at strides that
are multiples of 8 elements from 16-byte aligned starts on the wgmma +
TMA product of ``csrc/wgmma_gemm.cuh`` (NN for H's projections, TN for
I's weight gradients, NT for I's g1 and dfeats; exported bare as
``wgmma_gemm``); their other products (f32, the exact parity path, and
other widths) run on the hand-written GEMM of ``csrc/tile_gemm.cuh``
(bf16 on the tensor cores through wmma, exact f32 FMAs for f32),
exported bare as ``tile_gemm``. The kernels make that choice
(``wgmma_gemm::fits``).

TMA reads rows whose stride is a multiple of 16 bytes, so both kernels
take feats as B*K rows of F1 at a row stride that is a multiple of 8
elements (``feats_rows``): the model builds its node features in rows
padded that way (``padded_rows``; 2052 -> 2056 at the VQA width) and
hands over the unpadded view, and a contiguous feats of another width
is copied into such rows.

The public functions take JAX's layout: adj (B, K, K) f32, pseudo (B, K,
K, 2) f32, feats (B, K, F1), w1 (n, F1, d1), w2 (n, n*d1, d2), gp (4, n)
f32, seeds (B,) int32. The kernel wrappers take the projections side by
side, W1cat (F1, n*d1) and W2cat (n*d1, n*d2), column block n*d:(n+1)*d
being kernel n. The block keeps the projections in f32 up to the
aggregation, where the unmerged path rounds them to the compute dtype:
the two agree in f32 and differ at bf16 rounding in bf16.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vqa_project_tpu_torch.ops import _build
from vqa_project_tpu_torch.ops.dropout import keep_threshold
from vqa_project_tpu_torch.ops.edge_aggregate import (
    _check_like, sel_aggregate_act_reference,
    sel_aggregate_act_residuals_reference, sel_aggregate_act_vjp_reference)
from vqa_project_tpu_torch.ops.neighbourhood import masked_neighbourhood

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LAYOUTS = {"nn": 0, "nt": 1, "tn": 2}
_EPILOGUES = {"f32": 0, "operand": 1, "gate": 2}
_MAX_K, _MAX_KERNELS = 64, 32
ROW_ALIGN = 8   # elements: TMA's 16-byte row strides in bf16


# ---------------- the operands' layout ----------------


def padded_rows(parts, dtype: torch.dtype) -> torch.Tensor:
    """The (B, K, F) concatenation of ``parts`` along the last dim in
    ``dtype``, built in rows padded with zeros to a multiple of
    ``ROW_ALIGN`` elements: the unpadded view of that buffer, whose row
    stride the block's kernels read without a copy."""
    b, k = parts[0].shape[:2]
    f = sum(p.shape[-1] for p in parts)
    ld = -(-f // ROW_ALIGN) * ROW_ALIGN
    buf = torch.empty((b, k, ld), dtype=dtype, device=parts[0].device)
    buf[..., f:].zero_()
    at = 0
    for p in parts:
        buf[..., at:at + p.shape[-1]].copy_(p)
        at += p.shape[-1]
    return buf[..., :f]


def _row_stride(t: torch.Tensor) -> Optional[int]:
    """The one stride of a (B, K, F) tensor's B*K rows of unit-stride
    elements, or None when the rows are not evenly spaced."""
    b, k, f = t.shape
    if f > 1 and t.stride(2) != 1:
        return None
    if k == 1:
        ld = t.stride(0) if b > 1 else f
    else:
        ld = t.stride(1)
        if b > 1 and t.stride(0) != k * ld:
            return None
    return ld if ld >= f else None


def feats_rows(feats: torch.Tensor):
    """(feats, ldf): feats (B, K, F1) as kernels H and I read it, B*K rows
    of F1 at the row stride ldf. Rows at a stride that is a multiple of
    ``ROW_ALIGN`` from a 16-byte aligned start pass as they are; a
    contiguous feats whose width is not such a multiple is copied into
    padded rows; any other layout raises."""
    if feats.dim() != 3:
        raise ValueError(f"feats must be (B, K, F1), got "
                         f"{tuple(feats.shape)}")
    ld = _row_stride(feats)
    if ld is not None and ld % ROW_ALIGN == 0:
        if feats.data_ptr() % 16:
            raise ValueError("feats must start on a 16-byte boundary")
        return feats, ld
    if feats.is_contiguous():
        x = padded_rows([feats], feats.dtype)
        return x, x.stride(1)
    raise ValueError(f"feats rows must lie at one stride that is a "
                     f"multiple of {ROW_ALIGN} elements, got strides "
                     f"{feats.stride()}")


# ---------------- the bare product ----------------


def tile_gemm_reference(a: torch.Tensor, b: torch.Tensor, layout: str = "nn",
                        epilogue: str = "f32",
                        gate: Optional[torch.Tensor] = None,
                        scale: float = 1.0) -> torch.Tensor:
    """Plain version of ``tile_gemm``: the product in float32 (bf16
    operands are exact in f32), then the epilogue."""
    a32, b32 = a.float(), b.float()
    if layout == "nt":
        b32 = b32.t()
    elif layout == "tn":
        a32 = a32.t()
    elif layout != "nn":
        raise ValueError(f"layout must be nn, nt or tn, got {layout!r}")
    c = torch.mm(a32, b32)
    if epilogue == "operand":
        return c.to(a.dtype)
    if epilogue == "gate":
        return torch.where(gate.float() > 0, c * scale, torch.zeros_like(c))
    if epilogue != "f32":
        raise ValueError(f"epilogue must be f32, operand or gate, got "
                         f"{epilogue!r}")
    return c


def tile_gemm(a: torch.Tensor, b: torch.Tensor, layout: str = "nn",
              epilogue: str = "f32", gate: Optional[torch.Tensor] = None,
              scale: float = 1.0) -> torch.Tensor:
    """C = op(a) op(b) in the block's hand-written GEMM, all operands
    row-major: "nn" a (M, K) b (K, N); "nt" a (M, K) b (N, K), a @ b.T;
    "tn" a (K, M) b (K, N), a.T @ b. Operands float32 (exact f32) or
    bfloat16 (tensor cores, f32 sums). The epilogue stores f32
    ("f32"), a's dtype ("operand"), or f32 gated by ``gate`` (M, N) in
    a's dtype: gate > 0 ? c * scale : 0 ("gate")."""
    if a.device.type == "cpu":
        return tile_gemm_reference(a, b, layout, epilogue, gate, scale)
    if layout not in _LAYOUTS or epilogue not in _EPILOGUES:
        raise ValueError(f"layout {layout!r} / epilogue {epilogue!r}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError(f"operands must both be float32 or bfloat16, got "
                        f"{a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or b.device != a.device:
        raise ValueError("tile_gemm takes two 2-D tensors on one device")
    for name, t in (("a", a), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, k = (a.shape[1], a.shape[0]) if layout == "tn" else tuple(a.shape)
    n, kb = (b.shape[0], b.shape[1]) if layout == "nt" else (b.shape[1],
                                                             b.shape[0])
    if k != kb:
        raise ValueError(f"inner sizes differ: {k} and {kb}")
    out = torch.empty((m, n), device=a.device,
                      dtype=a.dtype if epilogue == "operand"
                      else torch.float32)
    if epilogue == "gate":
        _check_like("gate", gate, (m, n), a.dtype, a.device)
    lib = _build.load("graph_block")
    rc = lib.tile_gemm_run(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        gate.data_ptr() if epilogue == "gate" else None, m, n, k,
        a.shape[1], b.shape[1], n, _LAYOUTS[layout], _DTYPE_CODE[a.dtype],
        _EPILOGUES[epilogue], float(scale),
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "tile_gemm_run")
    tile_gemm.launches += 1
    return out


_build.counted(tile_gemm)


def wgmma_gemm(a: torch.Tensor, b: torch.Tensor, tile=(0, 0),
               layout: str = "nn", epilogue: str = "f32",
               gate: Optional[torch.Tensor] = None,
               scale: float = 1.0) -> torch.Tensor:
    """C = op(a) op(b) in kernels H's and I's wgmma + TMA product, bf16
    operands, f32 sums, in ``tile_gemm``'s layouts ("nn", "nt", "tn")
    and epilogues ("f32"; "operand" = bf16 and "gate" in "nt", kernel
    I's dfeats and g1, only). a and b may be
    views whose rows lie at a stride that is a multiple of 8 elements.
    Its plain version is ``tile_gemm_reference``.

    ``tile`` (BM, BN) = (128, 128), (128, 256) or (192, 192) forces a
    tile; (0, 0), what kernels H and I always take, is ``pick_tile``'s
    choice (``csrc/wgmma_gemm.cuh``). The forced tiles and this bare
    entry exist so that chip_smoke.py can check and time every tile of
    each layout beside the pick at the block's shapes."""
    if a.device.type == "cpu":
        return tile_gemm_reference(a, b, layout, epilogue, gate, scale)
    if layout not in _LAYOUTS or epilogue not in _EPILOGUES:
        raise ValueError(f"layout {layout!r} / epilogue {epilogue!r}")
    if epilogue != "f32" and layout != "nt":
        raise ValueError("wgmma_gemm takes the gate and operand epilogues "
                         "in the nt layout only")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"wgmma_gemm takes bfloat16 operands, got "
                        f"{a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or b.device != a.device:
        raise ValueError("wgmma_gemm takes two 2-D tensors on one device")
    if a.stride(1) != 1 or b.stride(1) != 1:
        raise ValueError("a's and b's rows must be contiguous")
    m, k = (a.shape[1], a.shape[0]) if layout == "tn" else tuple(a.shape)
    n, kb = (b.shape[0], b.shape[1]) if layout == "nt" else (b.shape[1],
                                                             b.shape[0])
    if k != kb:
        raise ValueError(f"inner sizes differ: {k} and {kb}")
    out = torch.empty((m, n), device=a.device,
                      dtype=a.dtype if epilogue == "operand"
                      else torch.float32)
    if epilogue == "gate":
        _check_like("gate", gate, (m, n), a.dtype, a.device)
    lib = _build.load("graph_block")
    rc = lib.wgmma_gemm_run(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        gate.data_ptr() if epilogue == "gate" else None, m, n, k,
        a.stride(0), b.stride(0), n, _LAYOUTS[layout], _EPILOGUES[epilogue],
        float(scale), *tile, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "wgmma_gemm_run")
    wgmma_gemm.launches += 1
    return out


_build.counted(wgmma_gemm)


# ---------------- selection and the chained oracle ----------------


def select_both(adj: torch.Tensor, m: int):
    """(mask, alpha) of the block's in-kernel selection: entry (i, j) is
    selected when fewer than m entries of row i beat it, an equal entry
    at a lower index counting as one that beats it (so exactly m per
    row, ties to the lowest index); alpha is the softmax of the
    adjacency over the selected entries. The same mask as
    ``masked_neighbourhood``, by ranks instead of a sort."""
    adj = adj.float()
    k = adj.shape[-1]
    beats = adj[..., None, :] > adj[..., :, None]          # (.., j, j')
    idx = torch.arange(k, device=adj.device)
    ties = (adj[..., None, :] == adj[..., :, None]) & (idx[None, :]
                                                       < idx[:, None])
    rank = (beats | ties).sum(dim=-1)
    mask = (rank < m).float()
    masked = torch.where(mask > 0, adj, torch.full_like(adj, -1e30))
    rowmax = masked.amax(dim=-1, keepdim=True)
    ex = torch.exp(masked - rowmax) * mask
    alpha = ex / ex.sum(dim=-1, keepdim=True)
    return mask, alpha


def _stacked(w: torch.Tensor) -> torch.Tensor:
    """(n, in, d) -> (in, n*d), column block n*d:(n+1)*d = w[n]."""
    n, fin, d = w.shape
    return w.permute(1, 0, 2).reshape(fin, n * d)


def _unstacked(wcat: torch.Tensor, n: int) -> torch.Tensor:
    """(in, n*d) -> (n, in, d)."""
    fin, nd = wcat.shape
    return wcat.reshape(fin, n, nd // n).permute(1, 0, 2)


def fused_graph_block_reference(adj, pseudo, feats, w1, gp1, w2, gp2, *, m,
                                keep_mask=None, dropout_rate=0.0,
                                compute_dtype=torch.float32):
    """The chained oracle (JAX's ``fused_graph_block_reference``): the
    projections, the two plain aggregations and the activation tail, in
    differentiable torch ops, with an optional frozen dropout
    ``keep_mask`` (B, K, n*d1) applied after conv1's relu."""
    cdt = compute_dtype
    b, k = feats.shape[:2]
    alpha, mask = masked_neighbourhood(adj, m)
    proj1 = torch.einsum("bkf,nfd->bknd", feats.to(cdt).float(),
                         w1.to(cdt).float()).reshape(b, k, -1)
    h1 = sel_aggregate_act_reference(alpha, pseudo, proj1, gp1, relu=True)
    if keep_mask is not None:
        h1 = h1 * keep_mask / (1.0 - dropout_rate)
    proj2 = torch.einsum("bkf,nfd->bknd", h1.to(cdt).float(),
                         w2.to(cdt).float()).reshape(b, k, -1)
    return sel_aggregate_act_reference(mask, pseudo, proj2, gp2, relu=True)


# ---------------- kernel H ----------------


class BlockResiduals(NamedTuple):
    """Kernel H's outputs: ``out`` and what the backward reads."""

    out: torch.Tensor     # (B, K, n*d2), compute dtype
    h1: torch.Tensor      # (B, K, n*d1), compute dtype
    alpha: torch.Tensor   # (B, K, K) f32
    mask: torch.Tensor    # (B, K, K) f32
    ghat1: torch.Tensor   # (B, n, K, K) f32
    ghat2: torch.Tensor   # (B, n, K, K) f32
    den1: torch.Tensor    # (B, K, K) f32
    den2: torch.Tensor    # (B, K, K) f32
    proj1: torch.Tensor   # (B*K, n*d1) f32
    proj2: torch.Tensor   # (B*K, n*d2) f32


def _check_d(w1cat: torch.Tensor, w2cat: torch.Tensor, n: int):
    nd1, nd2 = w1cat.shape[1], w2cat.shape[1]
    if nd1 % n or nd2 % n or w2cat.shape[0] != nd1:
        raise ValueError(f"w1cat {tuple(w1cat.shape)} / w2cat "
                         f"{tuple(w2cat.shape)} do not fit n={n}")
    d1, d2 = nd1 // n, nd2 // n
    # JAX's kernel reuses its conv1 scratch for conv2 and refuses
    # d2 > d1; the port keeps the rule so that both accept one set of
    # shapes (the model has d1 = 2 hid / n, d2 = hid / n)
    if d2 > d1:
        raise ValueError(f"fused_graph_block requires d2 <= d1; got "
                         f"d1={d1}, d2={d2}")
    return d1, d2


def graph_block_fwd_reference(adj, pseudo, feats, w1cat, w2cat, gp1, gp2,
                              seeds=None, m: int = 16,
                              dropout_rate: float = 0.0) -> BlockResiduals:
    """Plain version of kernel H, output for output: the projections in
    f32 from operands in feats' dtype, conv1 through kernel C's plain
    version (its relu and Philox dropout), conv2 likewise."""
    b, k, _ = feats.shape
    n = gp1.shape[1]
    _check_d(w1cat, w2cat, n)
    cdt = feats.dtype
    proj1 = tile_gemm_reference(feats.reshape(b * k, -1), w1cat)
    mask, alpha = select_both(adj, m)
    h1, ghat1, den1 = sel_aggregate_act_residuals_reference(
        alpha, pseudo, proj1.reshape(b, k, -1), gp1, True, dropout_rate,
        seeds)
    h1 = h1.to(cdt)
    proj2 = tile_gemm_reference(h1.reshape(b * k, -1), w2cat)
    out, ghat2, den2 = sel_aggregate_act_residuals_reference(
        mask, pseudo, proj2.reshape(b, k, -1), gp2, relu=True)
    return BlockResiduals(out.to(cdt), h1, alpha, mask, ghat1, ghat2, den1,
                          den2, proj1, proj2)


def graph_block_fwd(adj, pseudo, feats, w1cat, w2cat, gp1, gp2, seeds=None,
                    m: int = 16, dropout_rate: float = 0.0,
                    out: Optional[BlockResiduals] = None) -> BlockResiduals:
    """Kernel H on CUDA tensors (five launches: the Gaussians with the
    selection, proj1, conv1, proj2, conv2), its plain version on CPU
    tensors. feats (rows as ``feats_rows`` takes them), w1cat and w2cat
    in the compute dtype (float32 or bfloat16); seeds (B,) int32 when
    dropout_rate > 0. On CUDA tensors ``out``, residuals of the shapes
    and dtypes below, is written and returned instead of new ones."""
    feats, ldf = feats_rows(feats)
    if feats.device.type == "cpu":
        return graph_block_fwd_reference(adj, pseudo, feats, w1cat, w2cat,
                                         gp1, gp2, seeds, m, dropout_rate)
    dev, cdt = feats.device, feats.dtype
    if cdt not in _DTYPE_CODE:
        raise TypeError(f"feats must be float32 or bfloat16, got {cdt}")
    b, k, f1 = feats.shape
    n = gp1.shape[1] if gp1.dim() == 2 else -1
    if gp1.shape != (4, n) or n > _MAX_KERNELS:
        raise ValueError(f"gp1 must be (4, n<={_MAX_KERNELS}), got "
                         f"{tuple(gp1.shape)}")
    if not 0 < m <= k <= _MAX_K:
        raise ValueError(f"the block needs 0 < m <= K <= {_MAX_K}, got "
                         f"m={m}, K={k}")
    d1, d2 = _check_d(w1cat, w2cat, n)
    f32 = torch.float32
    if feats.device != dev:
        raise ValueError(f"feats is on {feats.device}")
    _check_like("w1cat", w1cat, (f1, n * d1), cdt, dev)
    _check_like("w2cat", w2cat, (n * d1, n * d2), cdt, dev)
    _check_like("adj", adj, (b, k, k), f32, dev)
    _check_like("pseudo", pseudo, (b, k, k, 2), f32, dev)
    _check_like("gp1", gp1, (4, n), f32, dev)
    _check_like("gp2", gp2, (4, n), f32, dev)
    drop = dropout_rate > 0
    if drop:
        if not dropout_rate < 1:
            raise ValueError(f"dropout rate must be in [0, 1), got "
                             f"{dropout_rate}")
        if seeds is None:
            raise ValueError("in-kernel dropout needs per-image seeds (B,)")
        _check_like("seeds", seeds, (b,), torch.int32, dev)
    lib = _build.load("graph_block")
    shapes = BlockResiduals(
        out=((b, k, n * d2), cdt), h1=((b, k, n * d1), cdt),
        alpha=((b, k, k), f32), mask=((b, k, k), f32),
        ghat1=((b, n, k, k), f32), ghat2=((b, n, k, k), f32),
        den1=((b, k, k), f32), den2=((b, k, k), f32),
        proj1=((b * k, n * d1), f32), proj2=((b * k, n * d2), f32))
    if out is None:
        res = BlockResiduals(*(torch.empty(shape, dtype=dt, device=dev)
                               for shape, dt in shapes))
    else:
        for name, t, (shape, dt) in zip(out._fields, out, shapes):
            _check_like(name, t, shape, dt, dev)
        res = out
    rc = lib.graph_block_fwd(
        adj.data_ptr(), pseudo.data_ptr(), feats.data_ptr(),
        w1cat.data_ptr(), w2cat.data_ptr(), gp1.data_ptr(), gp2.data_ptr(),
        seeds.data_ptr() if drop else None, res.proj1.data_ptr(),
        res.proj2.data_ptr(), res.h1.data_ptr(), res.out.data_ptr(),
        res.alpha.data_ptr(), res.mask.data_ptr(), res.ghat1.data_ptr(),
        res.ghat2.data_ptr(), res.den1.data_ptr(), res.den2.data_ptr(), b, k,
        f1, ldf, n, d1, d2, m, keep_threshold(dropout_rate) if drop else 0,
        1.0 / (1.0 - dropout_rate) if drop else 1.0, _DTYPE_CODE[cdt],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "graph_block_fwd")
    graph_block_fwd.launches += 1
    return res


_build.counted(graph_block_fwd)


# ---------------- kernel I ----------------


class BlockGrads(NamedTuple):
    """Kernel I's outputs: the merged block's gradients in the kernels'
    layout."""

    dadj: torch.Tensor                # (B, K, K) f32
    dpseudo: torch.Tensor             # (B, K, K, 2) f32
    dfeats: Optional[torch.Tensor]    # (B, K, F1) compute dtype, or None
    dw1cat: torch.Tensor              # (F1, n*d1) f32
    dw2cat: torch.Tensor              # (n*d1, n*d2) f32
    dgp1: torch.Tensor                # (4, n) f32
    dgp2: torch.Tensor                # (4, n) f32


def graph_block_bwd_reference(g, res: BlockResiduals, pseudo, feats, w1cat,
                              w2cat, gp1, gp2, dropout_rate: float = 0.0,
                              need_dfeats: bool = True) -> BlockGrads:
    """Plain version of kernel I: the hand VJP of kernel H from its
    residuals. Each conv's aggregation backward is kernel D's plain
    version; the per-conv dproj is rounded once to the compute dtype
    before the products, which sum in f32."""
    b, k, _ = feats.shape
    cdt = feats.dtype
    inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0 else 1.0
    _, dpseudo2, dp2, dgp2 = sel_aggregate_act_vjp_reference(
        g.float(), res.mask, res.ghat2, res.den2, pseudo,
        res.proj2.reshape(b, k, -1), gp2, out=res.out)
    dp2 = dp2.to(cdt).reshape(b * k, -1)
    h1 = res.h1.reshape(b * k, -1)
    dw2cat = tile_gemm_reference(h1, dp2, "tn")
    g1 = tile_gemm_reference(dp2, w2cat, "nt", "gate", h1, inv_keep)
    dsel1, dpseudo1, dp1, dgp1 = sel_aggregate_act_vjp_reference(
        g1.reshape(b, k, -1), res.alpha, res.ghat1, res.den1, pseudo,
        res.proj1.reshape(b, k, -1), gp1)
    dadj = res.alpha * (dsel1 - (dsel1 * res.alpha).sum(-1, keepdim=True))
    dp1 = dp1.to(cdt).reshape(b * k, -1)
    dw1cat = tile_gemm_reference(feats.reshape(b * k, -1), dp1, "tn")
    dfeats = (tile_gemm_reference(dp1, w1cat, "nt", "operand").reshape(
        feats.shape) if need_dfeats else None)
    return BlockGrads(dadj, dpseudo2 + dpseudo1, dfeats, dw1cat, dw2cat,
                      dgp1, dgp2)


def graph_block_bwd(g, res: BlockResiduals, pseudo, feats, w1cat, w2cat,
                    gp1, gp2, dropout_rate: float = 0.0,
                    need_dfeats: bool = True,
                    out: Optional[BlockGrads] = None) -> BlockGrads:
    """Kernel I on CUDA tensors (up to eight launches), its plain version
    on CPU tensors: the gradients as ``graph_block_bwd_reference``
    returns them, g (B, K, n*d2) float32; feats as kernel H took it.
    ``out``, gradients of the shapes and dtypes of ``BlockGrads`` (dfeats
    None unless asked for), is written and returned instead of new
    ones."""
    feats, ldf = feats_rows(feats)
    if feats.device.type == "cpu":
        grads = graph_block_bwd_reference(g, res, pseudo, feats, w1cat,
                                          w2cat, gp1, gp2, dropout_rate,
                                          need_dfeats)
        if out is None:
            return grads
        for t, x in zip(out, grads):
            if x is not None:
                t.copy_(x)
        return out
    dev, cdt = feats.device, feats.dtype
    b, k, f1 = feats.shape
    n = gp1.shape[1]
    d1, d2 = _check_d(w1cat, w2cat, n)
    if k > _MAX_K or n > _MAX_KERNELS or cdt not in _DTYPE_CODE:
        raise ValueError(f"the block needs K <= {_MAX_K}, n <= "
                         f"{_MAX_KERNELS}, float32 or bfloat16 feats")
    f32 = torch.float32
    _check_like("g", g, (b, k, n * d2), f32, dev)
    _check_like("out", res.out, (b, k, n * d2), cdt, dev)
    _check_like("h1", res.h1, (b, k, n * d1), cdt, dev)
    if feats.device != dev:
        raise ValueError(f"feats is on {feats.device}")
    _check_like("w1cat", w1cat, (f1, n * d1), cdt, dev)
    _check_like("w2cat", w2cat, (n * d1, n * d2), cdt, dev)
    _check_like("proj1", res.proj1, (b * k, n * d1), f32, dev)
    _check_like("proj2", res.proj2, (b * k, n * d2), f32, dev)
    for name in ("alpha", "mask", "den1", "den2"):
        _check_like(name, getattr(res, name), (b, k, k), f32, dev)
    for name in ("ghat1", "ghat2"):
        _check_like(name, getattr(res, name), (b, n, k, k), f32, dev)
    _check_like("pseudo", pseudo, (b, k, k, 2), f32, dev)
    _check_like("gp1", gp1, (4, n), f32, dev)
    _check_like("gp2", gp2, (4, n), f32, dev)
    shapes = BlockGrads(
        dadj=((b, k, k), f32), dpseudo=((b, k, k, 2), f32),
        dfeats=((b, k, f1), cdt), dw1cat=((f1, n * d1), f32),
        dw2cat=((n * d1, n * d2), f32), dgp1=((4, n), f32),
        dgp2=((4, n), f32))
    if out is None:
        def empty(name):
            shape, dt = getattr(shapes, name)
            return torch.empty(shape, dtype=dt, device=dev)

        # dgp1 and dgp2 are the partials' sums, made below
        grads = BlockGrads(empty("dadj"), empty("dpseudo"),
                           empty("dfeats") if need_dfeats else None,
                           empty("dw1cat"), empty("dw2cat"), None, None)
    else:
        if (out.dfeats is not None) != need_dfeats:
            raise ValueError("out.dfeats must be given exactly when "
                             "need_dfeats is")
        for name, t, (shape, dt) in zip(BlockGrads._fields, out, shapes):
            if t is not None:
                _check_like(name, t, shape, dt, dev)
        grads = out
    lib = _build.load("graph_block_bwd")
    f32d = dict(dtype=f32, device=dev)
    ge = torch.empty((b, n, k, k), **f32d)
    dp2 = torch.empty((b * k, n * d2), dtype=cdt, device=dev)
    g1 = torch.empty((b * k, n * d1), **f32d)
    dp1 = torch.empty((b * k, n * d1), dtype=cdt, device=dev)
    # conv2's and conv1's (4, n) gparams partials, one column per image
    # and row group of the edge part
    parts = torch.empty((2, 4, n, b * lib.graph_block_bwd_groups(k)),
                        **f32d)
    inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0 else 1.0
    rc = lib.graph_block_bwd(
        g.data_ptr(), res.out.data_ptr(), res.h1.data_ptr(),
        feats.data_ptr(), w1cat.data_ptr(), w2cat.data_ptr(),
        res.proj1.data_ptr(), res.proj2.data_ptr(), res.alpha.data_ptr(),
        res.mask.data_ptr(), res.ghat1.data_ptr(), res.ghat2.data_ptr(),
        res.den1.data_ptr(), res.den2.data_ptr(), pseudo.data_ptr(),
        gp1.data_ptr(), gp2.data_ptr(), ge.data_ptr(), dp2.data_ptr(),
        g1.data_ptr(), dp1.data_ptr(), grads.dadj.data_ptr(),
        grads.dpseudo.data_ptr(),
        grads.dfeats.data_ptr() if need_dfeats else None,
        grads.dw1cat.data_ptr(), grads.dw2cat.data_ptr(),
        parts[1].data_ptr(), parts[0].data_ptr(), b, k, f1, ldf, n, d1, d2,
        inv_keep, _DTYPE_CODE[cdt], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "graph_block_bwd")
    graph_block_bwd.launches += 1
    # the partials, summed along their rows in a fixed order (no atomics)
    dgp = parts.sum(dim=-1)
    if out is None:
        return grads._replace(dgp1=dgp[1], dgp2=dgp[0])
    grads.dgp1.copy_(dgp[1])
    grads.dgp2.copy_(dgp[0])
    return grads


_build.counted(graph_block_bwd)


# ---------------- autograd and the entry ----------------


def _kernel_inputs(adj, pseudo, feats, w1, gp1, w2, gp2):
    """JAX's layout -> the kernels': (adj, pseudo, feats, W1cat, W2cat,
    gp1, gp2), feats in rows as ``feats_rows`` gives them, the rest
    contiguous, the weights in feats' dtype, the rest f32."""
    cdt = feats.dtype
    return (adj.float().contiguous(), pseudo.float().contiguous(),
            feats_rows(feats)[0], _stacked(w1).to(cdt).contiguous(),
            _stacked(w2).to(cdt).contiguous(), gp1.float().contiguous(),
            gp2.float().contiguous())


class GraphBlockFunction(torch.autograd.Function):
    """Autograd of the merged block: kernel H saves its residuals (the
    f32 projections included), kernel I computes every gradient from
    them with no forward recompute. Inputs in JAX's layout."""

    @staticmethod
    def forward(ctx, adj, pseudo, feats, w1, gp1, w2, gp2, seeds, m,
                dropout_rate):
        args = _kernel_inputs(adj, pseudo, feats, w1, gp1, w2, gp2)
        res = graph_block_fwd(*args, seeds, m, dropout_rate)
        ctx.n, ctx.dropout_rate = w1.shape[0], dropout_rate
        ctx.w_dtypes = (w1.dtype, w2.dtype)
        ctx.save_for_backward(*args[1:], *res)
        return res.out

    @staticmethod
    def backward(ctx, g):
        pseudo, feats, w1cat, w2cat, gp1, gp2, *saved = ctx.saved_tensors
        res = BlockResiduals(*saved)
        dadj, dpseudo, dfeats, dw1cat, dw2cat, dgp1, dgp2 = graph_block_bwd(
            g.float().contiguous(), res, pseudo, feats, w1cat, w2cat, gp1,
            gp2, ctx.dropout_rate, need_dfeats=ctx.needs_input_grad[2])
        dw1 = _unstacked(dw1cat, ctx.n).to(ctx.w_dtypes[0])
        dw2 = _unstacked(dw2cat, ctx.n).to(ctx.w_dtypes[1])
        return dadj, dpseudo, dfeats, dw1, dgp1, dw2, dgp2, None, None, None


def fused_graph_block(adj: torch.Tensor, pseudo: torch.Tensor,
                      feats: torch.Tensor, w1: torch.Tensor,
                      gp1: torch.Tensor, w2: torch.Tensor, gp2: torch.Tensor,
                      seeds: Optional[torch.Tensor] = None, m: int = 16,
                      dropout_rate: float = 0.0) -> torch.Tensor:
    """relu(conv2(mask, dropout(relu(conv1(alpha, feats @ W1))) @ W2)),
    the top-m neighbourhood selected from ``adj`` inside the block.

    adj (B, K, K) f32; pseudo (B, K, K, 2); feats (B, K, F1) in the
    compute dtype; w1 (n, F1, d1) and w2 (n, n*d1, d2), cast to feats'
    dtype; gp1, gp2 (4, n); seeds (B,) int32 when dropout_rate > 0.
    Returns (B, K, n*d2) in feats' dtype. Differentiable in adj, pseudo,
    feats, w1, gp1, w2 and gp2 (kernels H and I); without a gradient to
    record it runs kernel H alone and keeps nothing.
    """
    wants_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (adj, pseudo, feats, w1, gp1, w2, gp2))
    if wants_grad:
        return GraphBlockFunction.apply(adj, pseudo, feats, w1, gp1, w2, gp2,
                                        seeds, m, dropout_rate)
    return graph_block_fwd(*_kernel_inputs(adj, pseudo, feats, w1, gp1, w2,
                                           gp2), seeds, m, dropout_rate).out
