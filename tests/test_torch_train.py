"""The port's training slice against the JAX package, on CPU.

One train step of the whole model (tiny tests/test_model.py::CFG, f32,
dropout 0) from the same weights and batch: loss, every gradient (mapped
by name through state_dict_from_jax_params) and the parameters after one
Adam step, with JAX running its Pallas kernels in interpret mode and
either GRU backward. Then the losses, the label helpers, the schedule,
the train-mode forward's dropout, fit and the checkpoint round trip.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_model import CFG, make_batch
from vqa_project_tpu.models import GraphVQAModel as JaxModel
from vqa_project_tpu.ops import losses as j_losses
from vqa_project_tpu.train import steps as j_steps
from vqa_project_tpu.train.state import make_lr_schedule
from vqa_project_tpu_torch.config import ModelConfig, TrainConfig
from vqa_project_tpu_torch.data import generate_synthetic_vqa
from vqa_project_tpu_torch.models import (GraphVQAModel,
                                          load_reference_checkpoint,
                                          state_dict_from_jax_params)
from vqa_project_tpu_torch.ops.losses import (multilabel_soft_margin_loss,
                                              vqa_score)
from vqa_project_tpu_torch.train import (densify_labels, fit,
                                         load_checkpoint, make_optimizer,
                                         save_checkpoint, sparse_vqa_score,
                                         train_step)

LR = 1e-3
# f32 on both sides; sums run in other orders (XLA's dots and the
# Pallas interpret kernels against torch's), so each gradient is held
# to its own scale: max |port - jax| / max |jax| per tensor
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def flush_denormals():
    """XLA:CPU flushes denormals; run torch's CPU kernels the same way
    (see tests/test_torch_model.py)."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _port_cfg(**kw) -> ModelConfig:
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    base = {k: v for k, v in dataclasses.asdict(CFG).items() if k in fields}
    base.update(kw)
    return ModelConfig(**base)


def _batch(rng, b=4):
    q, image, qlen = (np.array(a) for a in make_batch(rng, b))
    answers = (rng.uniform(size=(b, CFG.out_dim))
               * (rng.uniform(size=(b, CFG.out_dim)) < 0.2)
               ).astype(np.float32)
    votes = rng.integers(0, 4, size=(b, CFG.out_dim)).astype(np.float32)
    mask = np.ones((b,), np.float32)
    mask[-1] = 0.0  # a padded row: counts in neither the loss nor the score
    return {"question": q, "image": image, "qlen": qlen,
            "answers": answers, "votes": votes, "mask": mask}


def _norm_err(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.mark.parametrize("pallas_gru_bwd", [False, True])
def test_one_train_step_matches_jax(rng, monkeypatch, pallas_gru_bwd):
    if pallas_gru_bwd:
        monkeypatch.setenv("VQAX_PALLAS_GRU_BWD", "1")
    batch = _batch(rng)
    jcfg = dataclasses.replace(CFG, use_pallas=True, dropout=0.0)
    jmodel = JaxModel(cfg=jcfg)
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
    j_new = optax.apply_updates(params, updates)

    model = GraphVQAModel(_port_cfg(dropout=0.0), device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params))
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    optimizer, _ = make_optimizer(model, TrainConfig(lr=LR), 10)
    m = train_step(model, optimizer, None, batch)
    np.testing.assert_allclose(float(m["loss"]), float(j_loss), rtol=1e-5)
    assert float(m["valid"]) == 3.0

    want_g = state_dict_from_jax_params(j_grads)
    want_p = state_dict_from_jax_params(j_new)
    params_now = dict(model.named_parameters())
    assert set(want_g) == set(params_now)
    for name, p in params_now.items():
        g, wg = p.grad.numpy(), want_g[name].numpy()
        assert _norm_err(g, wg) <= GRAD_TOL, (name, _norm_err(g, wg))
        # Adam's first update is lr * g / (|g| + eps), about lr * sign(g):
        # held where |g| is clear of the gradient tolerance and of eps, so
        # that a rounding-level difference cannot flip or scale it
        clear = ((np.abs(wg) > 10 * GRAD_TOL * np.abs(wg).max())
                 & (np.abs(wg) > 100 * 1e-8))     # and of Adam's eps
        step_p = (p.detach() - p0[name]).numpy()
        step_j = (want_p[name] - p0[name]).numpy()
        np.testing.assert_allclose(step_p[clear], step_j[clear],
                                   rtol=1e-3, atol=1e-3 * LR, err_msg=name)
        assert np.abs(step_p).max() <= LR * 1.0001, name


def test_losses_match_jax(rng):
    b, c = 5, 7
    logits = rng.normal(size=(b, c)).astype(np.float32) * 3
    logits[-1, 2] = np.inf              # a padded row with garbage logits
    targets = rng.uniform(size=(b, c)).astype(np.float32)
    votes = rng.integers(0, 5, size=(b, c)).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0], np.float32)
    t = [torch.from_numpy(a) for a in (logits, targets, votes, mask)]
    got = multilabel_soft_margin_loss(t[0], t[1], t[3])
    want = j_losses.multilabel_soft_margin_loss(
        jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask))
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(
        float(multilabel_soft_margin_loss(t[0][:-1], t[1][:-1])),
        float(j_losses.multilabel_soft_margin_loss(
            jnp.asarray(logits[:-1]), jnp.asarray(targets[:-1]))),
        rtol=1e-6)
    logits[-1, 2] = 0.0
    t[0] = torch.from_numpy(logits)
    np.testing.assert_allclose(
        float(vqa_score(t[0], t[2], t[3])),
        float(j_losses.vqa_score(jnp.asarray(logits), jnp.asarray(votes),
                                 jnp.asarray(mask))), rtol=1e-6)


def test_label_helpers_match_jax(rng):
    b, s, c = 6, 16, 11
    # five distinct answers per row, then pad entries, as the table has
    idx = np.full((b, s), c - 1, np.int32)
    for r in range(b):
        idx[r, :5] = rng.permutation(c - 1)[:5]
    val = rng.uniform(size=(b, s)).astype(np.float32)
    val[:, 5:] = 0.0
    want = np.asarray(j_steps.densify_labels(jnp.asarray(idx),
                                             jnp.asarray(val), c))
    got = densify_labels(torch.from_numpy(idx), torch.from_numpy(val), c)
    np.testing.assert_array_equal(got.numpy(), want)
    logits = rng.normal(size=(b, c)).astype(np.float32)
    votes = (val * 10).round()
    mask = np.array([1, 0, 1, 1, 1, 0], np.float32)
    np.testing.assert_allclose(
        float(sparse_vqa_score(torch.from_numpy(logits),
                               torch.from_numpy(idx),
                               torch.from_numpy(votes),
                               torch.from_numpy(mask))),
        float(j_steps.sparse_vqa_score(jnp.asarray(logits), jnp.asarray(idx),
                                       jnp.asarray(votes),
                                       jnp.asarray(mask))), rtol=1e-6)


def test_lr_schedule_matches_optax():
    """MultiStepLR stepped every step with milestones in steps gives the
    learning rate of every update that optax's schedule gives."""
    cfg = TrainConfig(lr=0.1, lr_milestones=(2, 3), lr_gamma=0.5)
    spe = 3
    model = torch.nn.Linear(2, 2)
    optimizer, scheduler = make_optimizer(model, cfg, spe)
    sched = make_lr_schedule(cfg, spe)
    for count in range(14):   # the lr of update count+1
        assert optimizer.param_groups[0]["lr"] == pytest.approx(
            float(sched(count)), rel=1e-6), count
        optimizer.step()
        scheduler.step()


def test_train_forward_dropout(rng):
    """train=True applies dropout from the generator: the same seed gives
    the same logits, another seed others; eval mode ignores both."""
    q, image, qlen = (torch.from_numpy(np.asarray(a))
                      for a in make_batch(rng))
    model = GraphVQAModel(_port_cfg(dropout=0.5), device="cpu", seed=3)

    def run(seed):
        return model(q, image, qlen, train=True,
                     generator=torch.Generator().manual_seed(seed))[0]

    a, b, c = run(1), run(1), run(2)
    np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    assert not torch.equal(a, c)
    eval_logits = model(q, image, qlen)[0]
    assert eval_logits.grad_fn is None and not torch.equal(eval_logits, a)


def _tiny_run(tmp_path, **kw):
    ds = generate_synthetic_vqa(n_images=16, n_questions=256, n_obj=10,
                                feat_dim=32, q_vocab=30, n_answers=12,
                                emb_dim=16, max_qlen=8)
    mcfg = ModelConfig(hid_dim=32, combined_dim=20, n_kernels=4,
                       neighbourhood_size=5, dropout=0.1,
                       compute_dtype="float32")
    tcfg = TrainConfig(lr=3e-3, batch_size=16, log_interval=4,
                       save_dir=str(tmp_path), **kw)
    return ds, mcfg, tcfg


def test_fit_is_deterministic_and_learns(tmp_path):
    ds, mcfg, tcfg = _tiny_run(tmp_path, epochs=4, eval_interval=0)
    path = str(tmp_path / "m.jsonl")
    model_a, _, acc_a = fit(tcfg, mcfg, ds["train"], device="cpu",
                            jsonl_path=path)
    model_b, _, acc_b = fit(tcfg, mcfg, ds["train"], device="cpu")
    assert acc_a == acc_b
    for (k, va), vb in zip(model_a.state_dict().items(),
                           model_b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
    import json
    with open(path) as f:
        losses = [json.loads(line)["loss"] for line in f]
    assert len(losses) == 4 * 12 // 4            # 12 steps/epoch, windows of 4
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < 0.7 * np.mean(losses[:3])


def test_checkpoint_round_trip(tmp_path):
    ds, mcfg, tcfg = _tiny_run(tmp_path, epochs=1, eval_interval=6)
    model, optimizer, _ = fit(tcfg, mcfg, ds["train"], ds["val"],
                              device="cpu")
    path = tmp_path / "model_1.ckpt"
    assert path.exists()                  # written at the last eval step
    assert not list(tmp_path.glob("*.tmp"))
    payload = load_checkpoint(str(path))
    assert payload["epoch"] == 1 and payload["step"] == 12
    assert payload["extra"] == {"step_in_epoch": 0}
    assert payload["train_config"]["lr_milestones"] == (30,)
    # the weights load as a reference checkpoint, under its names
    sd = load_reference_checkpoint(str(path))
    assert set(sd) == set(model.state_dict())
    fresh = GraphVQAModel(model.cfg, device="cpu", seed=99)
    opt2, sched2 = make_optimizer(fresh, tcfg, 12)
    gen = torch.Generator()
    load_checkpoint(str(path), fresh, opt2, sched2, gen)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
    assert opt2.state_dict()["state"][0]["step"] == 12
    assert sched2.last_epoch == 12
    # saving again from the restored state gives the same payload
    save_checkpoint(str(tmp_path / "again.ckpt"), fresh, opt2, sched2,
                    step=12, epoch=1, generator=gen)
    again = load_checkpoint(str(tmp_path / "again.ckpt"))
    assert torch.equal(again["generator"], payload["generator"])
