"""How the merged block's kernels take their feature rows, on CPU.

Kernel H's wgmma projection reads feats by TMA, which needs row strides
that are multiples of 16 bytes, so the block takes feats as B*K rows at
a row stride that is a multiple of 8 elements (ops/graph_block.py::
feats_rows) and the model builds its nodes in rows padded that way
(padded_rows). Here: that layout gives the plain result of the
contiguous one and JAX's fused_graph_block (Pallas in interpret mode),
forward and gradients; the model's merged path hands the block padded
rows and still matches JAX's model and train step; the layout rules
reject what the kernels cannot read; the projection rule; dropout
written into padded rows. The CUDA kernels are held against these plain
versions on the card by chip_smoke.py (phase 13).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_model import CFG, make_batch
from tests.test_torch_graph_block import (BWD_TOL, FWD_TOL, GRAD_NAMES,
                                          SHAPES, _inputs, _t)
from tests.test_torch_model import _assert_agree
from tests.test_torch_train import _batch, _port_cfg
from vqa_project_tpu.models import GraphVQAModel as JaxModel
from vqa_project_tpu.ops import losses as j_losses
from vqa_project_tpu.ops.pallas.graph_block import \
    fused_graph_block as j_block
from vqa_project_tpu_torch.config import TrainConfig
from vqa_project_tpu_torch.models import (GraphVQAModel,
                                          state_dict_from_jax_params)
from vqa_project_tpu_torch.ops import graph_block
from vqa_project_tpu_torch.ops.dropout import dropout
from vqa_project_tpu_torch.ops.graph_block import (
    ROW_ALIGN, GraphBlockFunction, _kernel_inputs, feats_rows,
    graph_block_bwd, graph_block_fwd, padded_rows)
from vqa_project_tpu_torch.train import make_optimizer, train_step


@pytest.fixture(autouse=True)
def flush_denormals():
    """XLA:CPU flushes denormals; run torch's CPU kernels the same way
    (see tests/test_torch_model.py)."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _padded(x: torch.Tensor) -> torch.Tensor:
    return padded_rows([x], x.dtype)


@pytest.mark.parametrize("shape", SHAPES)
def test_padded_feats_forward_matches_contiguous_and_jax(rng, shape):
    """feats as a view of padded rows: kernel H's plain version gives the
    contiguous feats' outputs bit for bit, and the block's output matches
    JAX's kernel in interpret mode."""
    b, k, m, n, f1, d1, d2 = shape
    args = _inputs(rng, b, k, n, f1, d1, d2)
    want = np.asarray(j_block(*[jnp.asarray(a) for a in args], None, m, 0.0,
                              True))
    adj, pseudo, feats, w1, gp1, w2, gp2 = _t(args)
    view = _padded(feats)
    assert not view.is_contiguous() and view.stride(1) % ROW_ALIGN == 0
    dense = _kernel_inputs(adj, pseudo, feats, w1, gp1, w2, gp2)
    padded = _kernel_inputs(adj, pseudo, view, w1, gp1, w2, gp2)
    assert padded[2].data_ptr() == view.data_ptr()     # no copy
    res_d = graph_block_fwd(*dense, None, m)
    res_p = graph_block_fwd(*padded, None, m)
    for name, x, y in zip(res_d._fields, res_d, res_p):
        assert torch.equal(x, y), name
    np.testing.assert_allclose(res_p.out.numpy(), want, **FWD_TOL)
    g = torch.from_numpy(rng.normal(size=res_d.out.shape).astype(np.float32))
    grads_d = graph_block_bwd(g, res_d, *dense[1:])
    grads_p = graph_block_bwd(g, res_p, *padded[1:])
    for i, (x, y) in enumerate(zip(grads_d, grads_p)):
        assert torch.equal(x, y), i


@pytest.mark.parametrize("shape", SHAPES)
def test_padded_feats_gradients_match_jax(rng, shape):
    """The 7 gradients through GraphBlockFunction with feats a padded
    view (its gradient flows to the buffer's unpadded columns) against
    jax.grad of the interpret-mode kernel."""
    b, k, m, n, f1, d1, d2 = shape
    args = _inputs(rng, b, k, n, f1, d1, d2)
    want = jax.grad(lambda *a: jnp.sum(j_block(*a, None, m, 0.0, True) ** 2),
                    argnums=tuple(range(7)))(*[jnp.asarray(a) for a in args])
    targs = _t(args, grad=True)
    buf = torch.zeros((b, k, -(-f1 // ROW_ALIGN) * ROW_ALIGN))
    buf[..., :f1] = targs[2].detach()
    buf.requires_grad_(True)
    call = list(targs)
    call[2] = buf[..., :f1]
    GraphBlockFunction.apply(*call, None, m, 0.0).square().sum().backward()
    targs[2].grad = buf.grad[..., :f1]
    assert not buf.grad[..., f1:].any()
    for name, t, w in zip(GRAD_NAMES, targs, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=name, **BWD_TOL)


def test_feats_rows_rules():
    """Rows at a multiple-of-8 stride pass as they are; a contiguous odd
    width gets padded rows with the same values; a strided layout at
    another row stride, or a start off a 16-byte boundary, is refused."""
    x = torch.arange(2 * 3 * 13, dtype=torch.float32).reshape(2, 3, 13)
    got, ld = feats_rows(x)
    assert ld == 16 and got.stride() == (48, 16, 1)
    assert torch.equal(got, x)
    view = _padded(x)
    same, ld = feats_rows(view)
    assert same.data_ptr() == view.data_ptr() and ld == 16
    dense = torch.zeros(2, 3, 16, dtype=torch.bfloat16)
    assert feats_rows(dense)[0].data_ptr() == dense.data_ptr()
    with pytest.raises(ValueError, match="multiple of 8"):
        feats_rows(x[:, :, :12])          # rows 13 apart
    with pytest.raises(ValueError, match="multiple of 8"):
        feats_rows(x.transpose(0, 1))     # rows not at one stride
    flat = torch.zeros(1 + 2 * 3 * 16, dtype=torch.bfloat16)
    misaligned = flat[1:].view(2, 3, 16)  # 2 bytes past the allocation
    with pytest.raises(ValueError, match="16-byte"):
        feats_rows(misaligned)
    with pytest.raises(ValueError, match="16-byte"):
        graph_block_fwd(None, None, misaligned, None, None, None, None)


def test_padded_rows_builds_the_concatenation():
    a = torch.randn(2, 5, 9)
    b = torch.randn(2, 5, 4)
    got = padded_rows([a, b], torch.bfloat16)
    assert got.shape == (2, 5, 13) and got.stride(1) == 16
    assert torch.equal(got, torch.cat([a, b], -1).to(torch.bfloat16))
    buf = got.as_strided((2, 5, 16), got.stride())
    assert not buf[..., 13:].any()


@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_dropout_into_padded_rows(rate):
    """dropout(..., out=) draws the same numbers and writes the same
    values as without it, and leaves the padding alone."""
    x = torch.randn(3, 4, 13)
    want = dropout(x, rate, torch.Generator().manual_seed(5))
    view = _padded(x)
    got = dropout(view, rate, torch.Generator().manual_seed(5), out=view)
    assert got.data_ptr() == view.data_ptr() and torch.equal(got, want)
    assert not view.as_strided((3, 4, 16), view.stride())[..., 13:].any()


@pytest.fixture
def block_strides(monkeypatch):
    """The row strides of the feats that reach kernels H and I's
    wrappers from the model."""
    seen = {"fwd": [], "bwd": []}
    fwd, bwd = graph_block.graph_block_fwd, graph_block.graph_block_bwd

    def fwd_spy(adj, pseudo, feats, *a, **kw):
        seen["fwd"].append(feats.stride())
        return fwd(adj, pseudo, feats, *a, **kw)

    def bwd_spy(g, res, pseudo, feats, *a, **kw):
        seen["bwd"].append(feats.stride())
        return bwd(g, res, pseudo, feats, *a, **kw)

    monkeypatch.setattr(graph_block, "graph_block_fwd", fwd_spy)
    monkeypatch.setattr(graph_block, "graph_block_bwd", bwd_spy)
    return seen


def _padded_stride(k):
    ld = -(-CFG.feat_dim // ROW_ALIGN) * ROW_ALIGN
    assert ld != CFG.feat_dim       # the test width does get padded
    return (k * ld, ld, 1)


def test_model_merged_forward_on_padded_rows_matches_jax(rng,
                                                         block_strides):
    q, image, qlen = make_batch(rng)
    jmodel = JaxModel(cfg=CFG)
    params = jmodel.init(jax.random.key(3), q, image, qlen)
    want = jmodel.apply(params, q, image, qlen)
    model = GraphVQAModel(_port_cfg(merged_block=True), device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params))
    got = model(*(torch.from_numpy(np.array(x)) for x in (q, image, qlen)))
    assert block_strides["fwd"] == [_padded_stride(CFG.n_obj)]
    _assert_agree([o.numpy() for o in got], want)


def test_model_merged_train_step_on_padded_rows_matches_jax(rng,
                                                            block_strides):
    batch = _batch(rng)
    jmodel = JaxModel(cfg=dataclasses.replace(CFG, dropout=0.0))
    jq, jimage, jqlen = (jnp.asarray(batch[k])
                         for k in ("question", "image", "qlen"))
    params = jmodel.init(jax.random.key(11), jq, jimage, jqlen)

    def loss_fn(p):
        logits, _, _ = jmodel.apply(p, jq, jimage, jqlen, train=True,
                                    rngs={"dropout": jax.random.key(0)})
        return j_losses.multilabel_soft_margin_loss(
            logits, jnp.asarray(batch["answers"]), jnp.asarray(batch["mask"]))

    j_loss = jax.jit(loss_fn)(params)
    model = GraphVQAModel(_port_cfg(dropout=0.0, merged_block=True),
                          device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params))
    optimizer, _ = make_optimizer(model, TrainConfig(), 10)
    m = train_step(model, optimizer, None, batch)
    stride = _padded_stride(CFG.n_obj)
    assert block_strides == {"fwd": [stride], "bwd": [stride]}
    np.testing.assert_allclose(float(m["loss"]), float(j_loss), rtol=1e-5)


def test_wgmma_gemm_takes_padded_rows_on_cpu():
    """The bare wgmma product's CPU dispatch (its plain version) on a
    view of padded rows, against torch.mm of the same bf16 values."""
    a = _padded(torch.randn(1, 7, 13).to(torch.bfloat16))[0]
    b = torch.randn(13, 24).to(torch.bfloat16)
    assert a.stride(0) == 16
    got = graph_block.wgmma_gemm(a, b, (128, 128))
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.mm(a.float(), b.float()))
