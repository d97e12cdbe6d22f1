"""The merged graph block of the port (kernels H and I: ops/graph_block.py)
against the JAX package's fused_graph_block, on CPU.

The port's plain versions (what its wrappers run on CPU tensors) go
against the JAX Pallas kernel in interpret mode and its chained XLA
reference, forward and all 7 gradients, on the same numpy inputs; the
dropout epilogue against the JAX reference with the port's Philox keep
mask frozen; the in-block selection against JAX's _select_both and the
port's masked_neighbourhood; the bare GEMM's CPU dispatch against
torch.mm. The CUDA kernels are held against these plain versions on the
card by chip_smoke.py (phase 13).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_project_tpu.ops.pallas.graph_block import _select_both
from vqa_project_tpu.ops.pallas.graph_block import \
    fused_graph_block as j_block
from vqa_project_tpu.ops.pallas.graph_block import \
    fused_graph_block_reference as j_block_reference
from vqa_project_tpu_torch.ops.dropout import philox_keep
from vqa_project_tpu_torch.ops.edge_aggregate import \
    sel_aggregate_act_reference as agg
from vqa_project_tpu_torch.ops.graph_block import (
    GraphBlockFunction, fused_graph_block, fused_graph_block_reference,
    graph_block_bwd, graph_block_bwd_reference, graph_block_fwd,
    graph_block_fwd_reference, select_both, tile_gemm)
from vqa_project_tpu_torch.ops.neighbourhood import masked_neighbourhood

# f32 on both sides, sums in other orders (the JAX package's own forward
# tolerance for this kernel, tests/test_pallas.py)
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
# ... and its tolerance for the 7 gradients against the reference
BWD_TOL = dict(rtol=2e-3, atol=2e-4)
GRAD_NAMES = ("adj", "pseudo", "feats", "w1", "gp1", "w2", "gp2")
# JAX's test shapes (B, K, m, n, F1, d1, d2), and one with d2 == d1 at
# an odd feature width
SHAPES = [(4, 12, 5, 4, 68, 16, 8), (2, 20, 7, 4, 37, 8, 8)]


def _inputs(rng, b, k, n, f1, d1, d2):
    """numpy (adj, pseudo, feats, w1, gp1, w2, gp2), as JAX's test makes
    them."""
    adj = rng.normal(size=(b, k, k)).astype(np.float32)
    pseudo = np.stack([rng.uniform(0, 1.5, (b, k, k)),
                       rng.uniform(-np.pi, np.pi, (b, k, k))],
                      -1).astype(np.float32)
    feats = rng.normal(size=(b, k, f1)).astype(np.float32)
    w1 = (rng.normal(size=(n, f1, d1)) * .1).astype(np.float32)
    w2 = (rng.normal(size=(n, n * d1, d2)) * .1).astype(np.float32)

    def gp():
        return np.stack([rng.uniform(.2, 1, n), rng.uniform(-np.pi, np.pi, n),
                         rng.uniform(.2, 1, n),
                         rng.uniform(.2, 1, n)]).astype(np.float32)

    return adj, pseudo, feats, w1, gp(), w2, gp()


def _t(arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_jax_kernel(rng, shape):
    b, k, m, n, f1, d1, d2 = shape
    args = _inputs(rng, b, k, n, f1, d1, d2)
    jargs = [jnp.asarray(a) for a in args]
    want_kernel = np.asarray(j_block(*jargs, None, m, 0.0, True))
    want_ref = np.asarray(j_block_reference(*jargs, m=m))
    before = graph_block_fwd.launches
    got = fused_graph_block(*_t(args), None, m)
    assert graph_block_fwd.launches == before    # CPU: the plain version
    assert got.shape == want_kernel.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_kernel, **FWD_TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, **FWD_TOL)
    oracle = fused_graph_block_reference(*_t(args), m=m)
    np.testing.assert_allclose(oracle.numpy(), want_ref, **FWD_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_vjp_matches_jax_grad(rng, shape):
    """All 7 gradients through GraphBlockFunction (kernel I's plain
    version on CPU) against jax.grad of the interpret-mode kernel and of
    the XLA reference, for the loss sum(out^2)."""
    b, k, m, n, f1, d1, d2 = shape
    args = _inputs(rng, b, k, n, f1, d1, d2)
    jargs = [jnp.asarray(a) for a in args]
    want_k = jax.grad(lambda *a: jnp.sum(j_block(*a, None, m, 0.0, True)
                                         ** 2), argnums=tuple(range(7)))(
        *jargs)
    want_r = jax.grad(lambda *a: jnp.sum(j_block_reference(*a, m=m) ** 2),
                      argnums=tuple(range(7)))(*jargs)
    targs = _t(args, grad=True)
    before = graph_block_bwd.launches
    GraphBlockFunction.apply(*targs, None, m, 0.0).square().sum().backward()
    assert graph_block_bwd.launches == before
    for name, t, wk, wr in zip(GRAD_NAMES, targs, want_k, want_r):
        assert tuple(t.grad.shape) == np.shape(wk), name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wk),
                                   err_msg=name, **BWD_TOL)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wr),
                                   err_msg=name, **BWD_TOL)


def test_dropout_matches_reference_with_keep_mask(rng):
    """Rate 0.5: the port's in-block Philox epilogue against JAX's
    reference with the port's keep mask frozen, forward and gradients
    (the TPU kernel's own dropout draws from the TPU PRNG)."""
    b, k, m, n, f1, d1, d2 = SHAPES[0]
    rate = 0.5
    args = _inputs(rng, b, k, n, f1, d1, d2)
    seeds = torch.from_numpy(
        rng.integers(-2 ** 31, 2 ** 31 - 1, b).astype(np.int32))
    keep = philox_keep(seeds, (k, n * d1), rate).float().numpy()
    jargs = [jnp.asarray(a) for a in args]

    def j_loss(*a):
        return jnp.sum(j_block_reference(*a, m=m, keep_mask=keep,
                                         dropout_rate=rate) ** 2)

    want = np.asarray(j_block_reference(*jargs, m=m, keep_mask=keep,
                                        dropout_rate=rate))
    want_g = jax.grad(j_loss, argnums=tuple(range(7)))(*jargs)
    targs = _t(args, grad=True)
    got = fused_graph_block(*targs, seeds, m, rate)
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD_TOL)
    # dropped units: a different set from the undropped block
    plain = fused_graph_block(*_t(args), None, m)
    assert not torch.allclose(got.detach(), plain)
    got.square().sum().backward()
    for name, t, w in zip(GRAD_NAMES, targs, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=name, **BWD_TOL)
    # the frozen-mask oracle of the port gives the same forward
    oracle = fused_graph_block_reference(
        *_t(args), m=m, keep_mask=torch.from_numpy(keep), dropout_rate=rate)
    np.testing.assert_allclose(got.detach().numpy(), oracle.numpy(),
                               **FWD_TOL)


@pytest.mark.parametrize("k,m", [(12, 5), (36, 16), (51, 19)])
def test_select_both_matches_jax_and_masked_neighbourhood(rng, k, m):
    """Rows with ties (values on a coarse grid), an all-zero row (a
    ReLU-dead node) and an all-equal negative row: exactly m per row,
    the same mask as JAX's in-kernel rank and as masked_neighbourhood."""
    adj = np.round(rng.normal(size=(3, k, k)) * 2).astype(np.float32) / 2
    adj[0, 1] = 0.0
    adj[1, 2] = -1.5
    adj[2, :, :k // 2] = 0.0
    mask, alpha = select_both(torch.from_numpy(adj), m)
    for i in range(3):
        jm, ja = _select_both(jnp.asarray(adj[i]), m)
        np.testing.assert_array_equal(mask[i].numpy(), np.asarray(jm))
        np.testing.assert_allclose(alpha[i].numpy(), np.asarray(ja),
                                   rtol=1e-6, atol=1e-7)
    assert (mask.sum(-1) == m).all()
    n_alpha, n_mask = masked_neighbourhood(torch.from_numpy(adj), m)
    np.testing.assert_array_equal(mask.numpy(), n_mask.numpy())
    np.testing.assert_allclose(alpha.numpy(), n_alpha.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_d2_above_d1_raises(rng):
    """JAX refuses d2 > d1 (its conv1 scratch holds conv2's projection);
    the port refuses the same shapes."""
    args = _inputs(rng, 2, 8, 2, 12, 4, 8)
    with pytest.raises(ValueError, match="d2 <= d1"):
        j_block(*[jnp.asarray(a) for a in args], None, 3, 0.0, True)
    with pytest.raises(ValueError, match="d2 <= d1"):
        fused_graph_block(*_t(args), None, 3)
    with pytest.raises(ValueError, match="d2 <= d1"):
        GraphBlockFunction.apply(*_t(args, grad=True), None, 3, 0.0)


@pytest.mark.parametrize("layout", ["nn", "nt", "tn"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tile_gemm_cpu_dispatch(rng, layout, dtype):
    """The bare GEMM's CPU dispatch in each layout against torch.mm, and
    its epilogues: f32, the operand dtype, and the relu/dropout gate."""
    m, k, n = 13, 37, 9
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
    a, b = a.to(dtype), b.to(dtype)
    want = torch.mm(a.float(), b.float())
    a_in = a.t().contiguous() if layout == "tn" else a
    b_in = b.t().contiguous() if layout == "nt" else b
    before = tile_gemm.launches
    got = tile_gemm(a_in, b_in, layout)
    assert tile_gemm.launches == before
    assert got.dtype == torch.float32 and got.shape == (m, n)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    got_t = tile_gemm(a_in, b_in, layout, "operand")
    assert got_t.dtype == dtype
    torch.testing.assert_close(got_t, want.to(dtype), rtol=0, atol=0)
    gate = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32))
    gated = tile_gemm(a_in, b_in, layout, "gate", gate.to(dtype), 2.0)
    torch.testing.assert_close(
        gated, torch.where(gate.to(dtype).float() > 0, want * 2.0,
                           torch.zeros_like(want)), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="layout"):
        tile_gemm(a_in, b_in, "tt")


def test_wrappers_dispatch_to_plain_versions_on_cpu(rng):
    """On CPU tensors the kernel wrappers return their plain versions'
    results exactly and launch nothing; in f32 the block's residuals are
    those of the unmerged chain (kernel C's plain outputs)."""
    b, k, m, n, f1, d1, d2 = SHAPES[0]
    adj, pseudo, feats, w1, gp1, w2, gp2 = _t(_inputs(rng, b, k, n, f1, d1,
                                                      d2))
    w1cat = w1.permute(1, 0, 2).reshape(f1, -1).contiguous()
    w2cat = w2.permute(1, 0, 2).reshape(n * d1, -1).contiguous()
    seeds = torch.arange(b, dtype=torch.int32) * 7919 - 3
    fwd0, bwd0 = graph_block_fwd.launches, graph_block_bwd.launches
    res = graph_block_fwd(adj, pseudo, feats, w1cat, w2cat, gp1, gp2, seeds,
                          m, 0.5)
    ref = graph_block_fwd_reference(adj, pseudo, feats, w1cat, w2cat, gp1,
                                    gp2, seeds, m, 0.5)
    for x, y in zip(res, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    g = torch.from_numpy(rng.normal(size=res.out.shape).astype(np.float32))
    grads = graph_block_bwd(g, res, pseudo, feats, w1cat, w2cat, gp1, gp2,
                            0.5, need_dfeats=False)
    ref_g = graph_block_bwd_reference(g, res, pseudo, feats, w1cat, w2cat,
                                      gp1, gp2, 0.5, need_dfeats=False)
    assert grads[2] is None and ref_g[2] is None
    for x, y in zip(grads, ref_g):
        if x is not None:
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert (graph_block_fwd.launches, graph_block_bwd.launches) == (fwd0,
                                                                    bwd0)
    assert res.proj1.shape == (b * k, n * d1)
    assert torch.equal(res.mask.sum(-1), torch.full((b, k), float(m)))
    # the dropout mask is kernel C's: zero exactly where the Philox keep
    # mask drops a unit (among units whose pre-dropout value is positive)
    undropped = graph_block_fwd_reference(adj, pseudo, feats, w1cat, w2cat,
                                          gp1, gp2, None, m).h1
    keep = philox_keep(seeds, (k, n * d1), 0.5)
    pos = undropped > 0
    assert torch.equal((res.h1 > 0)[pos], keep[pos])


def test_bf16_block_stays_near_the_unmerged_rounding(rng):
    """bf16: the block keeps the projections in f32 where the unmerged
    chain rounds them to bf16 first; the two differ at the level of
    bf16 rounding (held within 2e-2 of the output's scale)."""
    b, k, m, n, f1, d1, d2 = SHAPES[0]
    adj, pseudo, feats, w1, gp1, w2, gp2 = _t(_inputs(rng, b, k, n, f1, d1,
                                                      d2))
    got = fused_graph_block(adj, pseudo, feats.bfloat16(), w1, gp1, w2, gp2,
                            None, m)
    assert got.dtype == torch.bfloat16
    alpha, mask = masked_neighbourhood(adj, m)
    f16, c16 = feats.bfloat16().float(), torch.bfloat16
    proj1 = torch.einsum("bkf,nfd->bknd", f16, w1.to(c16).float())
    h1 = agg(alpha, pseudo, proj1.reshape(b, k, -1).to(c16), gp1, relu=True)
    proj2 = torch.einsum("bkf,nfd->bknd", h1.float(), w2.to(c16).float())
    want = agg(mask, pseudo, proj2.reshape(b, k, -1).to(c16), gp2, relu=True)
    err = float((got.float() - want.float()).abs().max())
    assert 0 < err <= 2e-2 * float(want.float().abs().max())
