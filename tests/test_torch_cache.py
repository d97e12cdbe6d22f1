"""The device-cache path of the port against the JAX package, on CPU.

The index-mode Batcher and the packed index batch, the cache's mode
selection, the model's (features, boxes) input, one cache-mode training
step against JAX's cache-mode step (its Pallas kernels and its blocked
row gather in interpret mode), and fit in cache mode (its images
gathered as NodeImages) against host mode.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_model import CFG
from tests.test_torch_data import _datasets
from tests.test_torch_train import (GRAD_TOL, LR, _norm_err, _port_cfg,
                                    _tiny_run)
from vqa_project_tpu.config import TrainConfig as JTrainConfig
from vqa_project_tpu.data.loader import Batcher as JBatcher
from vqa_project_tpu.data.loader import pack_index_batch as j_pack
from vqa_project_tpu.models import GraphVQAModel as JaxModel
from vqa_project_tpu.ops import losses as j_losses
from vqa_project_tpu.parallel import make_mesh
from vqa_project_tpu.train import loop as j_loop
from vqa_project_tpu.train import steps as j_steps
from vqa_project_tpu.train.state import TrainState
from vqa_project_tpu_torch.config import TrainConfig
from vqa_project_tpu_torch.data import Batcher, pack_index_batch
from vqa_project_tpu_torch.models import (GraphVQAModel,
                                          state_dict_from_jax_params)
from vqa_project_tpu_torch.train import (QuantizedFeatureCache, fit,
                                         make_feature_cache, make_image_fn,
                                         make_optimizer, train_step,
                                         unpack_index_batch)

INDEX_FIELDS = ("question", "qlen", "qid", "mask", "index", "image_row",
                "ans_idx", "ans_score", "vote_idx", "vote_val")


@pytest.fixture(autouse=True)
def flush_denormals():
    """XLA:CPU flushes denormals; run torch's CPU kernels the same way
    (see tests/test_torch_model.py)."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_index_batcher_matches_jax(rng, shuffle, drop_last):
    jds, pds = _datasets(rng)
    jb = JBatcher(jds, 5, shuffle=shuffle, seed=7, drop_last=drop_last,
                  materialize=False)
    pb = Batcher(pds, 5, shuffle=shuffle, seed=7, drop_last=drop_last,
                 materialize=False)
    assert len(pb) == len(jb)
    for _ in range(2):                      # two epochs: the order moves
        got, want = list(pb), list(jb)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w) == set(INDEX_FIELDS)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    jb.set_epoch(3, skip=2)
    pb.set_epoch(3, skip=2)
    got, want = list(pb), list(jb)
    assert len(got) == len(want) == len(pb) - 2
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_pack_and_unpack_match_jax(rng):
    jds, pds = _datasets(rng)
    host = next(iter(Batcher(pds, 7, materialize=False)))
    got, want = pack_index_batch(host), j_pack(host)
    assert set(got) == set(want) == {"ints", "floats"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    unpacked = unpack_index_batch({k: torch.from_numpy(v)
                                   for k, v in got.items()})
    j_unpacked = j_steps.unpack_index_batch({k: jnp.asarray(v)
                                             for k, v in want.items()})
    assert set(unpacked) == set(j_unpacked)
    for k, v in unpacked.items():
        assert v.is_contiguous()
        np.testing.assert_array_equal(v.numpy(), np.asarray(j_unpacked[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(v.numpy(), host[k], err_msg=k)


def _same_cache(got, want):
    if want is None:
        assert got is None
        return
    if isinstance(want, j_steps.QuantizedFeatureCache):
        assert isinstance(got, QuantizedFeatureCache)
        assert got.out_dtype == want.out_dtype
        pairs = [(got.features, want.features), (got.scales, want.scales),
                 (got.boxes, want.boxes)]
    else:
        assert isinstance(got, tuple) and len(got) == len(want) == 2
        pairs = list(zip(got, want))
    for g, w in pairs:
        w = np.asarray(w)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        np.testing.assert_array_equal(g.float().numpy(),
                                      w.astype(np.float32))


# the _datasets table: features 5 x 4 x 6, boxes 5 x 4 x 4 (320 B);
# f32 800 B, bf16 560 B, int8 520 B with its scales
@pytest.mark.parametrize("cache_dtype,compute,budget", [
    ("auto", "float32", 1 << 20), ("auto", "bfloat16", 1 << 20),
    ("float32", "bfloat16", 1 << 20), ("bfloat16", "float32", 1 << 20),
    ("int8", "bfloat16", 1 << 20), ("float32", "float32", 799),
    ("bfloat16", "float32", 560), ("int8", "float32", 519)])
def test_make_feature_cache_matches_jax(rng, capsys, cache_dtype, compute,
                                        budget):
    jds, pds = _datasets(rng)
    want = j_loop.make_feature_cache(
        jds, make_mesh(1), JTrainConfig(feature_cache_dtype=cache_dtype,
                                        device_cache_bytes=budget), compute)
    j_out = capsys.readouterr().out
    got = make_feature_cache(pds, TrainConfig(feature_cache_dtype=cache_dtype,
                                              device_cache_bytes=budget),
                             compute, device="cpu")
    out = capsys.readouterr().out
    _same_cache(got, want)
    # the over-budget message of the single-card path is JAX's
    assert ("streaming features from host" in out) == (
        "streaming features from host" in j_out) == (want is None)
    assert ("int8 feature table" in out) == ("int8 feature table" in j_out)


def _cache_and_batch(rng, n_images=6, b=4):
    """A feature table with boxes, and an index batch over it with
    sparse labels (a few answers per row, pad entries) and a padded
    last row."""
    k, f = CFG.n_obj, CFG.feat_dim - 4
    feats = rng.normal(size=(n_images, k, f)).astype(np.float32)
    xy1 = rng.uniform(0, 0.5, size=(n_images, k, 2))
    wh = rng.uniform(0.05, 0.5, size=(n_images, k, 2))
    boxes = np.concatenate([xy1, xy1 + wh], -1).astype(np.float32)
    s, pad = 16, CFG.out_dim - 1
    ans_idx = np.full((b, s), pad, np.int32)
    vote_idx = np.full((b, s), pad, np.int32)
    ans_score = np.zeros((b, s), np.float32)
    vote_val = np.zeros((b, s), np.float32)
    for r in range(b):
        ans_idx[r, :3] = rng.permutation(pad)[:3]
        ans_score[r, :3] = rng.uniform(0.3, 1.0, 3)
        vote_idx[r, :3] = ans_idx[r, :3]
        vote_val[r, :3] = rng.integers(1, 10, 3)
    mask = np.ones((b,), np.float32)
    mask[-1] = 0.0
    host = {
        "question": rng.integers(1, CFG.vocab_size,
                                 (b, CFG.max_qlen)).astype(np.int32),
        "qlen": rng.integers(1, CFG.max_qlen + 1, b).astype(np.int32),
        "image_row": np.array([3, 0, 5, 3], np.int32)[:b],
        "ans_idx": ans_idx, "ans_score": ans_score, "vote_idx": vote_idx,
        "vote_val": vote_val, "mask": mask}
    return feats, boxes, host


def test_pair_input_equals_concatenated_input(rng):
    feats, boxes, host = _cache_and_batch(rng)
    rows = host["image_row"]
    q, qlen = torch.from_numpy(host["question"]), torch.from_numpy(host["qlen"])
    f_t, b_t = torch.from_numpy(feats[rows]), torch.from_numpy(boxes[rows])
    image = torch.cat([f_t, b_t], -1)
    for dtype in ("float32", "bfloat16"):
        model = GraphVQAModel(_port_cfg(compute_dtype=dtype, dropout=0.3),
                              device="cpu", seed=5)
        pair = (f_t.to(model.compute_dtype), b_t)  # the table's dtype
        for a, b in zip(model(q, image, qlen), model(q, pair, qlen)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)

        def train(x):
            return model(q, x, qlen, train=True,
                         generator=torch.Generator().manual_seed(3))[0]

        torch.testing.assert_close(train(image), train(pair), rtol=0, atol=0)


@pytest.mark.parametrize("pallas_gather,merged", [
    (False, False), (True, False), (False, True)],
    ids=["False", "True", "merged"])
def test_cache_train_step_matches_jax(rng, pallas_gather, merged):
    """One cache-mode step from the same weights, table and index batch:
    JAX's build_train_step (its densify, sparse score and row gather;
    pallas_gather runs the blocked Pallas gather in interpret mode) and
    the port's train_step with its image gather's plain version (the
    NodeImage; in padded rows for the port's merged block)."""
    feats, boxes, host = _cache_and_batch(rng)
    jcfg = dataclasses.replace(CFG, use_pallas=True, dropout=0.0)
    jmodel = JaxModel(cfg=jcfg)
    rows = host["image_row"]
    params = jmodel.init(
        jax.random.key(11), jnp.asarray(host["question"]),
        jnp.asarray(np.concatenate([feats[rows], boxes[rows]], -1)),
        jnp.asarray(host["qlen"]))
    cache = (jnp.asarray(feats), jnp.asarray(boxes))
    image_fn, arrays = j_steps.make_image_fn(cache, pallas_gather)

    def loss_fn(p):
        batch = {k: jnp.asarray(v) for k, v in j_pack(host).items()}
        q, image, qlen, answers_fn, score_fn = j_steps._assemble_inputs(
            batch, image_fn, arrays, CFG.out_dim)
        logits, _, _ = jmodel.apply(p, q, image, qlen, train=True,
                                    rngs={"dropout": jax.random.key(0)})
        return j_losses.multilabel_soft_margin_loss(
            logits, answers_fn(), batch["mask"]), score_fn(logits,
                                                           batch["mask"])

    (j_loss, j_score), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    tx = optax.adam(LR)
    step = j_steps.build_train_step(
        jmodel, tx, make_mesh(1), feature_cache=cache, n_answers=CFG.out_dim,
        pallas_gather=pallas_gather)
    state = TrainState(params=jax.tree.map(jnp.copy, params),
                       opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32), rng=jax.random.key(0))
    state, j_metrics = step(state, {k: jnp.asarray(v)
                                    for k, v in j_pack(host).items()})
    np.testing.assert_allclose(float(j_metrics["loss"]), float(j_loss),
                               rtol=1e-6)

    model = GraphVQAModel(_port_cfg(dropout=0.0, merged_block=merged),
                          device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params))
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    optimizer, _ = make_optimizer(model, TrainConfig(lr=LR), 10)
    m = train_step(model, optimizer, None, pack_index_batch(host), None,
                   make_image_fn((torch.from_numpy(feats),
                                  torch.from_numpy(boxes)),
                                 model.cfg.compute_dtype, merged))
    np.testing.assert_allclose(float(m["loss"]), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(float(m["score"]), float(j_score), rtol=1e-6)
    np.testing.assert_allclose(float(m["score"]),
                               float(j_metrics["score"]), rtol=1e-6)
    assert float(m["valid"]) == float(j_metrics["valid"]) == 3.0

    want_g = state_dict_from_jax_params(j_grads)
    want_p = state_dict_from_jax_params(state.params)
    params_now = dict(model.named_parameters())
    assert set(want_g) == set(params_now)
    for name, p in params_now.items():
        g, wg = p.grad.numpy(), want_g[name].numpy()
        assert _norm_err(g, wg) <= GRAD_TOL, (name, _norm_err(g, wg))
        # the Adam update, where |g| is clear of the tolerance and of eps
        clear = ((np.abs(wg) > 10 * GRAD_TOL * np.abs(wg).max())
                 & (np.abs(wg) > 100 * 1e-8))
        step_p = (p.detach() - p0[name]).numpy()
        step_j = (want_p[name] - p0[name]).numpy()
        np.testing.assert_allclose(step_p[clear], step_j[clear],
                                   rtol=1e-3, atol=1e-3 * LR, err_msg=name)


def test_fit_cache_mode_equals_host_mode(tmp_path):
    """fit with the device cache (index batches, gathers, labels
    densified on the device, resident mini-validation) takes the same
    steps as host mode: the same losses, accuracies and weights."""
    ds, mcfg, tcfg = _tiny_run(tmp_path, epochs=2, eval_interval=6)
    runs = {}
    for mode, kw in (("cache", {}), ("host", {"cache": None})):
        path = str(tmp_path / f"{mode}.jsonl")
        model, _, acc = fit(tcfg, mcfg, ds["train"], ds["val"],
                            device="cpu", jsonl_path=path, **kw)
        with open(path) as f:
            recs = [json.loads(line) for line in f]
        runs[mode] = (model, acc, [(r["loss"], r["vqa_acc"]) for r in recs])
    assert len(runs["cache"][2]) == 2 * 12 // 4
    assert runs["cache"][1:] == runs["host"][1:]
    for (k, a), b in zip(runs["cache"][0].state_dict().items(),
                         runs["host"][0].state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("merged,dtype", [
    (False, "bfloat16"), (True, "float32"), (True, "bfloat16")])
def test_fit_node_image_equals_host_mode(tmp_path, merged, dtype):
    """The case above with the merged block and in bf16: fit's image
    gather (NodeImage nodes in the compute dtype, padded rows for the
    merged block) takes the same steps as host mode's dense images."""
    ds, mcfg, tcfg = _tiny_run(tmp_path, epochs=1, eval_interval=6)
    mcfg = dataclasses.replace(mcfg, merged_block=merged,
                               compute_dtype=dtype)
    runs = {}
    for mode, kw in (("cache", {}), ("host", {"cache": None})):
        path = str(tmp_path / f"{mode}.jsonl")
        model, _, acc = fit(tcfg, mcfg, ds["train"], ds["val"],
                            device="cpu", jsonl_path=path, **kw)
        with open(path) as f:
            recs = [json.loads(line) for line in f]
        runs[mode] = (model, acc, [(r["loss"], r["vqa_acc"]) for r in recs])
    assert len(runs["cache"][2]) == 12 // 4
    assert runs["cache"][1:] == runs["host"][1:]
    for (k, a), b in zip(runs["cache"][0].state_dict().items(),
                         runs["host"][0].state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_fit_builds_the_cache_by_default(tmp_path, capsys):
    ds, mcfg, tcfg = _tiny_run(tmp_path, epochs=1, eval_interval=0)
    fit(dataclasses.replace(tcfg, device_cache_bytes=1000), mcfg,
        ds["train"], device="cpu")
    assert "streaming features from host" in capsys.readouterr().out
    cache = make_feature_cache(ds["train"], tcfg, mcfg.compute_dtype,
                               device="cpu")
    assert isinstance(cache, tuple) and cache[0].dtype == torch.float32
    assert tuple(cache[0].shape) == ds["train"].store.features.shape
