"""The port's model with ModelConfig.merged_block (both graph
convolutions as one merged block, kernels H and I) against the JAX
model, against the port's own unmerged path, and through fit, on CPU.

The JAX side runs its default path (tests/test_model.py::CFG); the
port runs its plain versions, on weights carried across by
state_dict_from_jax_params. All in f32, where the merged block's f32
projections equal the unmerged path's.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_model import CFG, make_batch
from tests.test_torch_model import _assert_agree
from tests.test_torch_train import (GRAD_TOL, LR, _batch, _norm_err,
                                    _port_cfg, _tiny_run)
from vqa_project_tpu.models import GraphVQAModel as JaxModel
from vqa_project_tpu.ops import losses as j_losses
from vqa_project_tpu_torch.config import TrainConfig
from vqa_project_tpu_torch.models import (GraphVQAModel,
                                          state_dict_from_jax_params)
from vqa_project_tpu_torch.ops import graph_block
from vqa_project_tpu_torch.train import fit, make_optimizer, train_step


@pytest.fixture(autouse=True)
def flush_denormals():
    """XLA:CPU flushes denormals; run torch's CPU kernels the same way
    (see tests/test_torch_model.py)."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.fixture
def block_calls(monkeypatch):
    """Counts the merged block's forward and backward calls on CPU,
    where the wrappers' launch counters stay at 0."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = graph_block.graph_block_fwd, graph_block.graph_block_bwd

    def counted_fwd(*a, **kw):
        calls["fwd"] += 1
        return fwd(*a, **kw)

    def counted_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(graph_block, "graph_block_fwd", counted_fwd)
    monkeypatch.setattr(graph_block, "graph_block_bwd", counted_bwd)
    return calls


def test_merged_forward_matches_jax(rng, block_calls):
    """Logits, adjacency and h_max_indices of the merged port against the
    JAX model's default forward, on the JAX weights."""
    q, image, qlen = make_batch(rng)
    jmodel = JaxModel(cfg=CFG)
    params = jmodel.init(jax.random.key(3), q, image, qlen)
    want = jmodel.apply(params, q, image, qlen)
    model = GraphVQAModel(_port_cfg(merged_block=True), device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params))
    got = model(*(torch.from_numpy(np.array(x)) for x in (q, image, qlen)))
    assert block_calls == {"fwd": 1, "bwd": 0}
    _assert_agree([o.numpy() for o in got], want)


def test_merged_train_step_matches_jax(rng, block_calls):
    """One merged train step (dropout 0) against JAX's: the loss, every
    gradient by name, and the Adam update."""
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

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = optax.adam(LR)
    updates, _ = tx.update(j_grads, tx.init(params), params)
    want_p = state_dict_from_jax_params(optax.apply_updates(params, updates))
    want_g = state_dict_from_jax_params(j_grads)

    model = GraphVQAModel(_port_cfg(dropout=0.0, merged_block=True),
                          device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params))
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    optimizer, _ = make_optimizer(model, TrainConfig(lr=LR), 10)
    m = train_step(model, optimizer, None, batch)
    assert block_calls == {"fwd": 1, "bwd": 1}
    np.testing.assert_allclose(float(m["loss"]), float(j_loss), rtol=1e-5)
    params_now = dict(model.named_parameters())
    assert set(want_g) == set(params_now)
    for name, p in params_now.items():
        g, wg = p.grad.numpy(), want_g[name].numpy()
        assert _norm_err(g, wg) <= GRAD_TOL, (name, _norm_err(g, wg))
        clear = ((np.abs(wg) > 10 * GRAD_TOL * np.abs(wg).max())
                 & (np.abs(wg) > 100 * 1e-8))
        np.testing.assert_allclose(
            (p.detach() - p0[name]).numpy()[clear],
            (want_p[name] - p0[name]).numpy()[clear], rtol=1e-3,
            atol=1e-3 * LR, err_msg=name)


def test_merged_equals_unmerged_with_dropout(rng, block_calls):
    """Dropout 0.5 from one generator seed: the merged block draws the
    same feature, conv1 and classifier masks as the unmerged path, so
    the loss and every gradient agree in f32."""
    batch = _batch(rng)
    results = {}
    for merged in (False, True):
        model = GraphVQAModel(_port_cfg(dropout=0.5, merged_block=merged),
                              device="cpu", seed=21)
        optimizer, _ = make_optimizer(model, TrainConfig(lr=LR), 10)
        m = train_step(model, optimizer, None, batch,
                       torch.Generator().manual_seed(5))
        results[merged] = (float(m["loss"]),
                           {k: p.grad.clone()
                            for k, p in model.named_parameters()})
    assert block_calls == {"fwd": 1, "bwd": 1}
    np.testing.assert_allclose(results[True][0], results[False][0],
                               rtol=1e-6)
    for name, g in results[False][1].items():
        err = _norm_err(results[True][1][name].numpy(), g.numpy())
        assert err <= 1e-5, (name, err)


def test_fit_merged_cache_mode_learns(tmp_path, capsys, block_calls):
    """A tiny fit with merged_block=True, in cache mode (the default when
    the table fits): the loss falls, and each step's loss is the
    unmerged fit's within f32 rounding."""
    ds, mcfg, tcfg = _tiny_run(tmp_path, epochs=4, eval_interval=0)
    losses = {}
    for merged in (True, False):
        path = str(tmp_path / f"{merged}.jsonl")
        model, _, _ = fit(tcfg, dataclasses.replace(mcfg,
                                                    merged_block=merged),
                          ds["train"], device="cpu", jsonl_path=path)
        assert model.cfg.merged_block is merged
        with open(path) as f:
            losses[merged] = [json.loads(line)["loss"] for line in f]
    assert "streaming features from host" not in capsys.readouterr().out
    assert block_calls == {"fwd": 48, "bwd": 48}   # 4 epochs x 12 steps
    got = np.array(losses[True])
    assert len(got) == 4 * 12 // 4 and np.isfinite(got).all()
    assert np.mean(got[-3:]) < 0.7 * np.mean(got[:3])
    np.testing.assert_allclose(got, losses[False], rtol=1e-4)
