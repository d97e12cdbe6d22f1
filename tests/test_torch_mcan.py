"""MCAN (``models/mcan.py``) on the CPU at small widths, held against the
benchmark's plain reference (``portbench/reference/mcan.py``, plain torch
in float32, which imports nothing of the port): the logits, the summed
BCE and every gradient leaf; three ``train_step``s with dropout replayed
(losses, parameters, Adam's moments); padding that changes nothing; the
region count's mask against MCAN's zero-row rule; and MCAN on the port's
normal path: ``fit``, its checkpoints, ``evaluate`` to ``result.json``
and ``cli/run.py --arch mcan``.

Tolerances: both sides compute in float32 with the same operations in
the same order but for the products' summation order (the program's
``matmul`` flattens the batch, ``torch.matmul`` of the reference keeps
it) and the layer norm's and softmax's reductions, so they agree to a
few float32 roundings: rtol 1e-5 with an atol of 1e-6 of each tensor's
scale (of the largest leaf's, for gradients). Adam's first steps move
each element by about lr whatever its gradient's size, so an element
whose gradient is 0 but for rounding (a key bias; a unit of AttFlat's
MLP live at every position, which the softmax's shift cancels) moves by
the sign of its noise: the parameters' change is compared, as a norm
gap of 5e-3 (16 seeds read at most 7.5e-4), over the leaves that move
(``checks.moving_leaves``) and their elements whose gradient is at least
1e-3 of the leaf's largest.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from portbench.harness.checks import moving_leaves
from portbench.harness.mcan import (leaves, make_weights, n_params, norms,
                                    program_config)
from portbench.reference.mcan import MCANReference, bce_sum, run_steps
from vqa_project_tpu_torch.config import ModelConfig, TrainConfig
from vqa_project_tpu_torch.data import generate_synthetic_vqa
from vqa_project_tpu_torch.data.loader import Batcher
from vqa_project_tpu_torch.data.store import region_counts
from vqa_project_tpu_torch.models import make_model
from vqa_project_tpu_torch.models.mcan import MCANModel
from vqa_project_tpu_torch.ops.gather_rows import RegionImage
from vqa_project_tpu_torch.ops.losses import bce_sum_loss
from vqa_project_tpu_torch.train import (build_model, evaluate, fit,
                                         load_checkpoint, make_image_fn,
                                         make_optimizer, save_checkpoint,
                                         train_step)
from vqa_project_tpu_torch.train.loop import make_feature_cache
from vqa_project_tpu_torch.train.steps import RegionCache

M = {"vocab_size": 50, "word_embed_size": 16, "img_feat_size": 40,
     "img_feat_pad_size": 9, "max_token": 7, "hidden_size": 32,
     "multi_head": 8, "hidden_size_head": 4, "ff_size": 128, "layer": 6,
     "flat_mlp_size": 512, "flat_glimpses": 1, "flat_out_size": 64,
     "answer_size": 30, "dropout_r": 0.1, "regions": [2, 9],
     "compute_dtype": "float32"}
B = 6


@pytest.fixture(autouse=True)
def _flush_denormals():
    old = torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(old)


def _model(m=M, seed=11):
    model = MCANModel(ModelConfig(**program_config(m)), device="cpu", seed=0)
    w = make_weights(m, seed, "cpu")
    model.load_state_dict(w)
    return model, w


def _inputs(seed=3, k=M["img_feat_pad_size"], t=M["max_token"]):
    """questions (ids past each length 0), features (rows past each
    count 0), counts, dense soft labels (answer_size + the pad slot)."""
    g = torch.Generator().manual_seed(seed)
    qlen = torch.randint(1, M["max_token"] + 1, (B,), generator=g)
    q = torch.randint(1, M["vocab_size"], (B, t), generator=g)
    q[torch.arange(t)[None, :] >= qlen[:, None]] = 0
    count = torch.randint(M["regions"][0], M["regions"][1] + 1, (B,),
                          generator=g, dtype=torch.int32)
    feats = torch.rand((B, k, M["img_feat_size"]), generator=g)
    feats[torch.arange(k)[None, :] >= count[:, None].long()] = 0.0
    labels = torch.zeros((B, M["answer_size"] + 1))
    labels.scatter_(1, torch.randint(0, M["answer_size"], (B, 3),
                                     generator=g), torch.rand((B, 3),
                                                              generator=g))
    return q, qlen, feats, count, labels


def _close(got, want, rtol=1e-5, scale=None):
    if scale is None:
        scale = float(want.detach().abs().max())
    torch.testing.assert_close(got, want, rtol=rtol, atol=1e-6 * scale)


def _grads_close(got, want):
    """Every leaf to rtol 2e-5 and an atol of 1e-6 of the largest
    gradient: the attention's key biases have a gradient of 0 but for
    rounding (the softmax does not see one shift of every score)."""
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        _close(got[name], g, rtol=2e-5, scale=scale)


def test_weights_are_the_models_state_dict_and_count():
    model, w = _model()
    sd = model.state_dict()
    assert set(sd) == set(w)
    for k in w:
        assert sd[k].shape == w[k].shape and torch.equal(sd[k], w[k])
    assert n_params(M) == sum(p.numel() for p in model.parameters())
    assert len(leaves(M)) + 2 * len(norms(M)) + 1 == len(sd)


def test_make_model_picks_the_architecture():
    cfg = ModelConfig(**program_config(M))
    assert isinstance(make_model(cfg, device="cpu"), MCANModel)
    with pytest.raises(ValueError, match="architecture"):
        make_model(dataclasses.replace(cfg, arch="nope"), device="cpu")


@pytest.mark.parametrize("key,value", [
    ("multi_head", 4), ("layer", 2), ("flat_mlp_size", 256),
    ("flat_glimpses", 2), ("ff_size", 96), ("flat_out_size", 32),
    ("hidden_size_head", 8)])
def test_program_config_refuses_a_width_the_program_fixes(key, value):
    """The reference and the counts read these widths from the
    configuration; the program fixes them, so another value is refused
    at set-up, not found by a failed comparison."""
    with pytest.raises(ValueError, match=key):
        program_config({**M, key: value})


@pytest.mark.parametrize("image", ["count", "dense", "pair"])
def test_eval_logits_match_the_reference(image):
    model, w = _model()
    q, qlen, feats, count, _ = _inputs()
    given = {"count": RegionImage(feats, count),
             "dense": torch.cat([feats, torch.rand((B, feats.shape[1], 4))],
                                -1),
             "pair": (feats, torch.rand((B, feats.shape[1], 4)))}[image]
    got, adjacency, _ = model(q, given, qlen)
    assert adjacency is None and got.shape == (B, M["answer_size"])
    _close(got, MCANReference(M).forward(w, q, feats))


def test_training_logits_loss_and_every_gradient_match_the_reference():
    model, w = _model()
    q, qlen, feats, count, labels = _inputs(5)
    mask = torch.tensor([1.0, 1, 1, 0, 1, 1])
    logits_p, _, _ = model(q, RegionImage(feats, count), qlen, train=True,
                           generator=torch.Generator().manual_seed(77))
    loss_p = model.loss(logits_p, labels, mask)
    loss_p.backward()
    wr = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ref = MCANReference(M)
    logits_r = ref.forward(wr, q, feats, torch.Generator().manual_seed(77))
    loss_r = bce_sum(logits_r, labels[:, :M["answer_size"]], mask)
    loss_r.backward()
    _close(logits_p, logits_r)
    _close(loss_p, loss_r)
    _grads_close({n: p.grad for n, p in model.named_parameters()},
                 {n: p.grad for n, p in wr.items()})


def test_bce_sum_is_torchs_summed_bce_with_logits():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((5, 7), generator=g) * 4
    y = torch.rand((5, 7), generator=g)
    mask = torch.tensor([1.0, 0, 1, 1, 0])
    want = torch.nn.functional.binary_cross_entropy_with_logits(
        x, y, reduction="none").sum(-1)
    _close(bce_sum_loss(x, y), want.sum())
    _close(bce_sum_loss(x, y, mask), (want * mask).sum())


def _index_batches(feats, count, q, labels, n, seed=0):
    """``n`` index batches of B rows over a table of the given images:
    image row i for row i, the labels as sparse entries."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rows = r.permutation(B)
        idx = np.full((B, 4), M["answer_size"], np.int32)
        val = np.zeros((B, 4), np.float32)
        for i, row in enumerate(rows):
            hot = torch.nonzero(labels[row, :M["answer_size"]])[:, 0]
            idx[i, :len(hot)] = hot.numpy()
            val[i, :len(hot)] = labels[row, hot].numpy()
        out.append({"question": q[rows].numpy().astype(np.int32),
                    "qlen": (q[rows] > 0).sum(1).numpy().astype(np.int32),
                    "image_row": rows.astype(np.int32),
                    "ans_idx": idx, "ans_score": val, "vote_idx": idx,
                    "vote_val": val * 3, "mask": np.ones(B, np.float32),
                    "qid": np.arange(B), "index": rows})
    return out, [{"question": q[b["image_row"]], "feats": feats[b["image_row"]],
                  "answers": labels[b["image_row"], :M["answer_size"]],
                  "mask": torch.ones(B)} for b in out]


def test_three_train_steps_match_the_reference_with_dropout_replayed():
    model, w = _model()
    q, _, feats, count, labels = _inputs(9)
    prog, ref_batches = _index_batches(feats, count, q, labels, 3)
    lr = 7e-3
    optimizer, scheduler = make_optimizer(model, TrainConfig(lr=lr), 100)
    image_fn = make_image_fn(RegionCache(feats, count), "float32")
    gen = torch.Generator().manual_seed(123)
    names = {p: n for n, p in model.named_parameters()}
    losses, mu1 = [], None
    for i, batch in enumerate(prog):
        out = train_step(model, optimizer, scheduler, batch, gen, image_fn)
        losses.append(float(out["loss"]))
        if i == 0:
            mu1 = {names[p]: st["exp_avg"].clone()
                   for p, st in optimizer.state.items()}
    losses_r, grad_r, change_r, _ = run_steps(MCANReference(M), w,
                                              ref_batches, lr, 123, "cpu")
    np.testing.assert_allclose(losses, losses_r, rtol=1e-5)
    _grads_close({n: v / 0.1 for n, v in mu1.items()}, grad_r)
    params = dict(model.named_parameters())
    for n in moving_leaves(grad_r):
        live = grad_r[n].abs() >= 1e-3 * grad_r[n].abs().max()
        gap = (params[n].detach() - w[n] - change_r[n])[live].norm()
        assert gap <= 5e-3 * change_r[n][live].norm(), n
    assert all(int(st["step"]) == 3 for st in optimizer.state.values())


def test_padding_changes_no_logit_nor_gradient():
    # no dropout: a wider input draws other masks
    model, _ = _model({**M, "dropout_r": 0.0})
    q, qlen, feats, count, labels = _inputs(13)
    k, t = feats.shape[1], q.shape[1]
    wide_f = torch.cat([feats, torch.zeros((B, 4, feats.shape[2]))], 1)
    wide_q = torch.cat([q, torch.zeros((B, 3), dtype=q.dtype)], 1)
    grads = []
    for qq, ff in ((q, feats), (wide_q, wide_f)):
        model.zero_grad(set_to_none=True)
        logits, _, _ = model(qq, RegionImage(ff, count), qlen, train=True)
        model.loss(logits, labels).backward()
        grads.append((logits.detach(),
                      {n: p.grad.clone() for n, p in model.named_parameters()}))
    assert wide_f.shape[1] == k + 4 and wide_q.shape[1] == t + 3
    _close(grads[1][0], grads[0][0])
    _grads_close(grads[1][1], grads[0][1])


def test_the_count_mask_is_mcans_zero_row_mask():
    model, _ = _model()
    _, _, feats, count, _ = _inputs(17)
    _, by_count = model.regions(RegionImage(feats, count))
    _, by_rows = model.regions(feats)
    assert torch.equal(by_count, by_rows)
    assert torch.equal(torch.from_numpy(region_counts(feats.numpy(), 2)),
                       count)
    # an image with no live row counts 0
    assert region_counts(np.zeros((1, 3, 2), np.float32)).tolist() == [0]


def test_the_region_gather_gives_rows_and_counts():
    _, _, feats, count, _ = _inputs(19)
    fn = make_image_fn(RegionCache(feats, count), "float32")
    rows = torch.tensor([4, 0, 99, -3], dtype=torch.int32)
    img = fn(rows)
    assert isinstance(img, RegionImage)
    want = rows.clamp(0, B - 1).long()
    assert torch.equal(img.feats, feats[want])
    assert torch.equal(img.count, count[want])


@pytest.fixture(scope="module")
def synthetic():
    return generate_synthetic_vqa(n_images=10, n_questions=64, n_obj=6,
                                  feat_dim=20, q_vocab=30, n_answers=8,
                                  seed=5, max_qlen=7)


MCFG = dict(arch="mcan", emb_dim=16, hid_dim=16, dropout=0.1,
            compute_dtype="float32")


def test_fit_checkpoint_round_trip_and_evaluate(synthetic, tmp_path):
    train_ds, val_ds = synthetic["train"], synthetic["val"]
    tcfg = TrainConfig(epochs=1, batch_size=8, log_interval=2,
                       eval_interval=4, save_dir=str(tmp_path), seed=3)
    model, optimizer, acc = fit(tcfg, ModelConfig(**MCFG), train_ds, val_ds,
                                device="cpu")
    assert isinstance(model, MCANModel) and np.isfinite(acc)
    assert not hasattr(train_ds.store, "region_counts")
    path = tmp_path / "m.ckpt"
    save_checkpoint(str(path), model, optimizer, step=3, model_cfg=model.cfg,
                    train_cfg=tcfg)
    fresh = build_model(ModelConfig(**MCFG), train_ds, device="cpu", seed=9)
    payload = load_checkpoint(str(path), fresh)
    assert payload["model_config"]["arch"] == "mcan"
    for (n, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), n
    out = tmp_path / "result.json"
    acc, result, adj = evaluate(fresh, val_ds, 8, result_path=str(out),
                                device="cpu")
    assert adj is None and np.isfinite(acc)
    written = json.loads(out.read_text())
    assert written == result
    assert sorted(r["question_id"] for r in written) == sorted(
        int(x) for x in val_ds.table.qid)
    assert all(r["answer"] in val_ds.a_wtoi for r in written)
    # host mode (no cache) answers the same
    acc2, result2, _ = evaluate(fresh, val_ds, 8, result_path=None,
                                cache=None, device="cpu")
    assert result2 == result and acc2 == pytest.approx(acc)


@pytest.mark.parametrize("cache_dtype,want", [("int8", torch.float32),
                                              ("float32", torch.float32),
                                              ("bfloat16", torch.bfloat16)])
def test_mcans_region_table_holds_the_stores_features(synthetic, cache_dtype,
                                                      want):
    """MCAN's region table has no int8 form: an int8 cache dtype keeps
    the features in the compute dtype, the store's values, and the counts
    are the store's (not a truncation to zero of features in [0, 1))."""
    store = synthetic["train"].store
    cache = make_feature_cache(
        synthetic["train"], TrainConfig(feature_cache_dtype=cache_dtype),
        "float32", "cpu", arch="mcan")
    assert isinstance(cache, RegionCache) and cache.features.dtype == want
    assert torch.equal(cache.features,
                       torch.from_numpy(store.features).to(want))
    assert torch.equal(cache.counts,
                       torch.from_numpy(region_counts(store.features)))
    assert not hasattr(store, "region_counts")


def test_the_batcher_counts_mcans_padded_rows(synthetic):
    from vqa_project_tpu_torch.train import profiling
    ds = synthetic["train"]
    counts = np.arange(ds.store.features.shape[0], dtype=np.int32) % 6 + 1
    profiling.clear_counts()
    try:
        assert next(iter(Batcher(ds, 8, materialize=False)))
        assert profiling.recent_counts() == []
        batch = next(iter(Batcher(ds, 8, materialize=False,
                                  region_counts=counts)))
        made = profiling.recent_counts()
    finally:
        profiling.clear_counts()
    rows = 8 * (ds.max_qlen + ds.n_obj)
    live = int(batch["qlen"].sum()) + int(counts[batch["image_row"]].sum())
    assert [(n, v) for n, v, _ in made] == [("batch.rows", rows),
                                           ("batch.padded_rows", rows - live)]


def test_cli_trains_and_evaluates_mcan(tmp_path, monkeypatch):
    from vqa_project_tpu_torch.cli import run as cli
    monkeypatch.chdir(tmp_path)
    common = ["--arch", "mcan", "--synthetic", "--data_dir", "data",
              "--device", "cpu", "--hid", "16", "--emb", "8", "--n_obj", "6",
              "--bsize", "8", "--compute_dtype", "float32",
              "--synthetic_questions", "48", "--synthetic_images", "8",
              "--synthetic_feat_dim", "12"]
    cli.main(["--train", "--ep", "1", "--save_dir", "save",
              "--log_interval", "2", "--eval_interval", "100",
              "--dropout", "0.1"] + common)
    assert os.path.exists("save/model_1.ckpt")
    cli.main(["--eval", "--model_path", "save/model_1.ckpt"] + common)
    assert json.loads(open("result.json").read())
