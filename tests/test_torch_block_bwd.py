"""Kernel I's order of sums (csrc/graph_block_bwd.cu), on CPU.

The kernel's dot part sums G_n = g_n proj_n^T in 64-column chunks, each
chunk's 16 column quads dealt round-robin to `groups` thread groups
whose sums meet in group order at the end; its edge part runs on a grid
of (row group, image), each block writing (4, n) gparams partials that
the wrapper sums in a fixed order; the cross term of the pseudo and
gparams gradients is rounded as the plain version rounds it, so that it
cancels exactly at n = 1. A plain torch model of that order
(``block_bwd_model``) goes against jax.vjp of the JAX package's
fused_graph_block (Pallas in interpret mode) and against the port's
plain version, on the same numpy inputs, in f32. The wrappers' CPU
dispatch of kernel I with ``out=`` and of the bare wgmma product in each
layout are checked too. The kernel itself is held against the plain
version on the card by chip_smoke.py (phase 13).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_project_tpu.ops.pallas.graph_block import \
    fused_graph_block as j_block
from vqa_project_tpu_torch.ops.graph_block import (
    BlockGrads, graph_block_bwd, graph_block_bwd_reference,
    graph_block_fwd_reference, padded_rows, tile_gemm_reference, wgmma_gemm)

# the JAX package's tolerance for this kernel's 7 gradients against its
# reference (tests/test_pallas.py; also tests/test_torch_graph_block.py)
BWD_TOL = dict(rtol=2e-3, atol=2e-4)
# the model against the port's plain version: both f32, sums in other
# orders only
ORDER_TOL = 1e-5
GRAD_NAMES = ("adj", "pseudo", "feats", "w1", "gp1", "w2", "gp2")

# the kernel's constants (graph_block_bwd.cu): threads a block, columns
# a chunk, column quads a chunk, G's register tile per side
THREADS, CHUNK, QUADS, G_TILE = 256, 64, 16, 4


def g_groups(k):
    """graph_block_bwd.cu::g_groups: the thread groups that split a
    chunk's column quads for G, G_TILE x G_TILE entries of G a thread."""
    t = -(-k // G_TILE)
    return min(THREADS // (t * t), QUADS)


def edge_rows(k):
    """graph_block_bwd.cu::edge_rows / edge_groups: (rows a block,
    row groups an image) of the edge part."""
    rows = min(k, THREADS // k)
    groups = -(-k // rows)
    return -(-k // groups), groups


def dot_part_model(g, gate, sel, ghat, proj, n):
    """(dp, G) of one conv: dp_n = (sel ghat_n)^T g_n, and G_n = g_n
    proj_n^T summed per group over its quads of every chunk, the groups
    then added in order. g gated by gate > 0 when a gate is given."""
    b, k, nd = g.shape
    d = nd // n
    if gate is not None:
        g = torch.where(gate.float() > 0, g, torch.zeros_like(g))
    g4 = g.reshape(b, k, n, d)
    p4 = proj.reshape(b, k, n, d)
    dp = torch.einsum("bnij,bind->bjnd", sel[:, None] * ghat,
                      g4).reshape(b, k, nd)
    groups = g_groups(k)
    part = [torch.zeros(b, n, k, k) for _ in range(groups)]
    for c0 in range(0, d, CHUNK):
        for q in range(QUADS):
            cols = slice(c0 + 4 * q, min(c0 + 4 * q + 4, d))
            if cols.start < d:
                part[q % groups] = part[q % groups] + torch.einsum(
                    "bind,bjnd->bnij", g4[..., cols], p4[..., cols])
    ge = part[0]
    for x in part[1:]:
        ge = ge + x
    return dp, ge


def edge_part_model(ge, sel, ghat, denom, pseudo, gparams, softmax):
    """(dadj or None, dpseudo, dgparams, the (B, groups, 4, n) partials)
    of one conv from G: every sum over the n kernels in kernel order, the
    cross term rounded per product, the gparams terms summed per (image,
    row group) and the partials then added in order."""
    b, n, k, _ = ge.shape
    s = sel[:, None]
    gms = ge * s
    sc = torch.zeros_like(sel)
    dsel = torch.zeros_like(sel)
    for q in range(n):
        sc = sc + gms[:, q] * ghat[:, q]
        dsel = dsel + ge[:, q] * ghat[:, q]
    den = denom[:, None]
    ind = (den > 1e-20).float()
    dwn_wn = ((gms - ind * sc[:, None]) / den) * (ghat * den)
    mu_r, mu_t, pr, pt = (gparams[i].reshape(1, n, 1, 1) for i in range(4))
    rho = pseudo[..., 0][:, None]
    theta = pseudo[..., 1][:, None]
    inv_r = 1.0 / (1e-14 + pr * pr)
    inv_t = 1.0 / (1e-14 + pt * pt)
    x_r = rho - mu_r
    first = torch.abs(theta - mu_t)
    second = torch.abs(2.0 * np.pi - first)
    dist = torch.minimum(first, second)
    dd = torch.where(first <= second, torch.ones_like(first),
                     -torch.sign(2.0 * np.pi - first))
    common = dwn_wn * (-dist * inv_t) * dd * torch.sign(theta - mu_t)
    drho_q = dwn_wn * (-x_r * inv_r)
    drho = torch.zeros_like(sel)
    dtheta = torch.zeros_like(sel)
    for q in range(n):
        drho = drho + drho_q[:, q]
        dtheta = dtheta + common[:, q]
    terms = torch.stack([dwn_wn * x_r * inv_r, -common,
                         dwn_wn * (x_r * x_r) * pr * inv_r * inv_r,
                         dwn_wn * (dist * dist) * pt * inv_t * inv_t],
                        dim=1)                       # (B, 4, n, K, K)
    rows, groups = edge_rows(k)
    parts = torch.stack([terms[..., r * rows:(r + 1) * rows, :].sum(
        dim=(-2, -1)) for r in range(groups)], dim=1)  # (B, groups, 4, n)
    dgp = torch.zeros(4, n)
    for x in parts.reshape(-1, 4, n):
        dgp = dgp + x
    dadj = None
    if softmax:
        dadj = sel * (dsel - (dsel * sel).sum(-1, keepdim=True))
    return dadj, torch.stack([drho, dtheta], dim=-1), dgp, parts


def block_bwd_model(g, res, pseudo, feats, w1cat, w2cat, gp1, gp2,
                    dropout_rate=0.0, need_dfeats=True):
    """Kernel I in its order: conv2's dot and edge parts, dW2 and the
    gated g1, conv1's dot and edge parts, dW1 and dfeats. The products
    are plain f32 matrix products (their order is the tensor cores')."""
    b, k, _ = feats.shape
    n = gp1.shape[1]
    cdt = feats.dtype
    inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate > 0 else 1.0
    dp2, ge2 = dot_part_model(g, res.out, res.mask, res.ghat2, res.proj2
                              .reshape(b, k, -1), n)
    _, dpseudo2, dgp2, _ = edge_part_model(ge2, res.mask, res.ghat2,
                                           res.den2, pseudo, gp2, False)
    dp2 = dp2.to(cdt).reshape(b * k, -1).float()
    h1 = res.h1.reshape(b * k, -1).float()
    dw2cat = h1.t() @ dp2
    g1 = torch.where(h1 > 0, (dp2 @ w2cat.float().t()) * inv_keep,
                     torch.zeros_like(h1))
    dp1, ge1 = dot_part_model(g1.reshape(b, k, -1), None, res.alpha,
                              res.ghat1, res.proj1.reshape(b, k, -1), n)
    dadj, dpseudo1, dgp1, _ = edge_part_model(ge1, res.alpha, res.ghat1,
                                              res.den1, pseudo, gp1, True)
    dp1 = dp1.to(cdt).reshape(b * k, -1).float()
    dw1cat = feats.reshape(b * k, -1).float().t() @ dp1
    dfeats = ((dp1 @ w1cat.float().t()).to(cdt).reshape(feats.shape)
              if need_dfeats else None)
    return BlockGrads(dadj, dpseudo2 + dpseudo1, dfeats, dw1cat, dw2cat,
                      dgp1, dgp2)


def _inputs(rng, b, k, n, f1, d1, d2, prec_lo=0.2):
    """numpy (adj, pseudo, feats, w1, gp1, w2, gp2), as JAX's test makes
    them; precisions drawn from [prec_lo, 1]."""
    adj = rng.normal(size=(b, k, k)).astype(np.float32)
    pseudo = np.stack([rng.uniform(0, 1.5, (b, k, k)),
                       rng.uniform(-np.pi, np.pi, (b, k, k))],
                      -1).astype(np.float32)
    feats = rng.normal(size=(b, k, f1)).astype(np.float32)
    w1 = (rng.normal(size=(n, f1, d1)) * .1).astype(np.float32)
    w2 = (rng.normal(size=(n, n * d1, d2)) * .1).astype(np.float32)

    def gp():
        return np.stack([rng.uniform(.2, 1, n), rng.uniform(-np.pi, np.pi, n),
                         rng.uniform(prec_lo, 1, n),
                         rng.uniform(prec_lo, 1, n)]).astype(np.float32)

    return adj, pseudo, feats, w1, gp(), w2, gp()


def _cat(w):
    """(n, in, d) -> (in, n*d), as the kernels take the weights."""
    n, fin, d = w.shape
    return w.permute(1, 0, 2).reshape(fin, n * d).contiguous()


def _uncat(wcat, n):
    fin, nd = wcat.shape
    return wcat.reshape(fin, n, nd // n).permute(1, 0, 2)


def _norm_err(got, want):
    want = want.float()
    scale = max(float(want.abs().max()), 1e-12)
    return float((got.float() - want).abs().max()) / scale


def _block(rng, b, k, m, n, f1, d1, d2, rate=0.0, prec_lo=0.2):
    """(numpy inputs, the kernels' torch inputs, residuals, g)."""
    args = _inputs(rng, b, k, n, f1, d1, d2, prec_lo)
    adj, pseudo, feats, w1, gp1, w2, gp2 = (torch.from_numpy(a)
                                            for a in args)
    w1cat, w2cat = _cat(w1), _cat(w2)
    seeds = (torch.arange(b, dtype=torch.int32) * 7919 - 3
             if rate > 0 else None)
    res = graph_block_fwd_reference(adj, pseudo, feats, w1cat, w2cat, gp1,
                                    gp2, seeds, m, rate)
    g = torch.from_numpy(rng.normal(size=res.out.shape).astype(np.float32))
    return args, (pseudo, feats, w1cat, w2cat, gp1, gp2), res, g


# (B, K, m, n, F1, d1, d2): d1 = 80 spans two chunks, the second partial;
# K = 10, 36, 51 give 16, 3 and 1 thread groups for G and 1, 6 and 11
# row groups for the edge part
MODEL_SHAPES = [(2, 10, 5, 2, 37, 80, 72), (2, 36, 16, 2, 37, 80, 40),
                (2, 51, 19, 2, 37, 80, 24)]


@pytest.mark.parametrize("shape", MODEL_SHAPES,
                         ids=[f"K={s[1]}" for s in MODEL_SHAPES])
def test_order_model_matches_jax_vjp(rng, shape):
    """All 7 gradients of the model (f32, no dropout) against jax.vjp of
    the interpret-mode kernel for the same cotangent, within the JAX
    package's own tolerance, and against the port's plain version within
    1e-5 normalized; with dropout 0.5 against the plain version."""
    b, k, m, n, f1, d1, d2 = shape
    args, kin, res, g = _block(rng, b, k, m, n, f1, d1, d2)
    assert (g_groups(k), edge_rows(k)[1]) == {10: (16, 1), 36: (3, 6),
                                              51: (1, 11)}[k]
    jargs = [jnp.asarray(a) for a in args]
    _, vjp = jax.vjp(lambda *a: j_block(*a, None, m, 0.0, True), *jargs)
    want = vjp(jnp.asarray(g.numpy()))
    got = block_bwd_model(g, res, *kin)
    plain = graph_block_bwd_reference(g, res, *kin)
    jax_layout = (got.dadj, got.dpseudo, got.dfeats, _uncat(got.dw1cat, n),
                  got.dgp1, _uncat(got.dw2cat, n), got.dgp2)
    for name, x, w in zip(GRAD_NAMES, jax_layout, want):
        assert tuple(x.shape) == np.shape(w), name
        np.testing.assert_allclose(x.numpy(), np.asarray(w), err_msg=name,
                                   **BWD_TOL)
    for name, x, y in zip(BlockGrads._fields, got, plain):
        assert _norm_err(x, y) <= ORDER_TOL, name

    _, kin, res, g = _block(rng, b, k, m, n, f1, d1, d2, rate=0.5)
    got = block_bwd_model(g, res, *kin, 0.5)
    plain = graph_block_bwd_reference(g, res, *kin, 0.5)
    for name, x, y in zip(BlockGrads._fields, got, plain):
        assert _norm_err(x, y) <= ORDER_TOL, name


@pytest.mark.parametrize("k,m", [(10, 5), (36, 16)])
def test_order_model_cancels_exactly_at_one_kernel(rng, k, m):
    """n = 1: ghat is 1 wherever the Gaussian clears the 1e-20 clamp (all
    edges here: precisions from [0.5, 1]), and the model's dpseudo and
    both dgparams are exactly 0, the partials too; its other gradients
    still match jax.vjp."""
    b, n, f1, d1, d2 = 2, 1, 37, 80, 40
    args, kin, res, g = _block(rng, b, k, m, n, f1, d1, d2, prec_lo=0.5)
    assert bool((res.den1 > 1e-20).all() and (res.den2 > 1e-20).all())
    got = block_bwd_model(g, res, *kin)
    for name in ("dpseudo", "dgp1", "dgp2"):
        x = getattr(got, name)
        assert torch.equal(x, torch.zeros_like(x)), name
    _, _, _, parts = edge_part_model(
        dot_part_model(g, res.out, res.mask, res.ghat2, res.proj2, n)[1],
        res.mask, res.ghat2, res.den2, kin[0], kin[5], False)
    assert parts.shape == (b, edge_rows(k)[1], 4, n)
    assert torch.equal(parts, torch.zeros_like(parts))
    jargs = [jnp.asarray(a) for a in args]
    _, vjp = jax.vjp(lambda *a: j_block(*a, None, m, 0.0, True), *jargs)
    want = vjp(jnp.asarray(g.numpy()))
    for name, x, w in ((("adj", got.dadj, want[0]),
                        ("feats", got.dfeats, want[2]),
                        ("w1", _uncat(got.dw1cat, n), want[3]),
                        ("w2", _uncat(got.dw2cat, n), want[5]))):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), err_msg=name,
                                   **BWD_TOL)


def test_kernel_grids_cover_every_row_and_column_once():
    """For every K the kernel takes (1..64): the edge part's row groups
    cover each adjacency row once with at most one edge per thread, and
    G's thread groups fit the block and deal out a chunk's quads."""
    for k in range(1, 65):
        rows, groups = edge_rows(k)
        assert rows * k <= THREADS and groups * rows >= k > (groups - 1) * rows
        t = -(-k // G_TILE)
        s = g_groups(k)
        assert 1 <= s <= QUADS and s * t * t <= THREADS and G_TILE * t >= k


@pytest.mark.parametrize("need_dfeats", [True, False])
def test_bwd_out_fills_given_tensors_on_cpu(rng, need_dfeats):
    """graph_block_bwd(..., out=) on CPU tensors takes the plain version,
    writes its bits into the given tensors and returns them; nothing is
    launched."""
    b, k, m, n, f1, d1, d2 = 2, 10, 5, 2, 37, 16, 8
    _, kin, res, g = _block(rng, b, k, m, n, f1, d1, d2, rate=0.5)
    want = graph_block_bwd_reference(g, res, *kin, 0.5, need_dfeats)
    out = BlockGrads(*(None if x is None else torch.full_like(x, np.nan)
                       for x in want))
    before = graph_block_bwd.launches
    got = graph_block_bwd(g, res, *kin, 0.5, need_dfeats, out=out)
    assert graph_block_bwd.launches == before
    assert isinstance(got, BlockGrads)
    assert (got.dfeats is None) == (not need_dfeats)
    for name, x, y, o in zip(BlockGrads._fields, got, want, out):
        if y is None:
            continue
        assert x is o, name
        assert torch.equal(x, y), name


@pytest.mark.parametrize("layout", ["nn", "nt", "tn"])
def test_wgmma_gemm_cpu_dispatch_in_each_layout(rng, layout):
    """The bare wgmma product's CPU dispatch in each layout and epilogue
    against tile_gemm_reference, bit for bit, with a given as a view of
    rows padded to a multiple of 8 (kernel I's feats in TN); nothing is
    launched."""
    m, k, n = 13, 37, 9
    bf = torch.bfloat16
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(bf)
    b = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(bf)
    a_in = a.t().contiguous() if layout == "tn" else a
    a_in = padded_rows([a_in[None]], bf)[0]
    assert a_in.stride(0) % 8 == 0 and a_in.stride(0) > a_in.shape[1]
    b_in = b.t().contiguous() if layout == "nt" else b
    gate = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)).to(bf)
    before = wgmma_gemm.launches
    for epilogue, gt, scale in (("f32", None, 1.0), ("operand", None, 1.0),
                                ("gate", gate, 2.0)):
        got = wgmma_gemm(a_in, b_in, (0, 0), layout, epilogue, gt, scale)
        want = tile_gemm_reference(a_in, b_in, layout, epilogue, gt, scale)
        assert got.shape == (m, n) and got.dtype == want.dtype
        assert torch.equal(got, want), epilogue
    assert wgmma_gemm.launches == before
    torch.testing.assert_close(
        wgmma_gemm(a_in, b_in, layout=layout), torch.mm(a.float(), b.float()),
        rtol=1e-6, atol=1e-6)
