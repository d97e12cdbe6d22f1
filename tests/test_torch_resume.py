"""Resuming the port's fit, on the CPU (dropout 0.5): a run resumed at an
epoch boundary or mid-epoch repeats the uninterrupted run bit for bit
(losses, learning rate, final weights); a reference full-dict ``.pt``
resumes to the weights and Adam moments the JAX package's
``_resume_checkpoint`` gives on the same file (0 tolerance); per-step
Adam counts that disagree are refused by both; a missing path raises and
a JAX msgpack checkpoint resumes."""

import collections
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from vqa_project_tpu.config import ModelConfig as JModelConfig
from vqa_project_tpu.config import TrainConfig as JTrainConfig
from vqa_project_tpu.data import GraphVQADataset as JDataset
from vqa_project_tpu.data.synthetic import generate_synthetic_vqa as j_gen
from vqa_project_tpu.train import loop as j_loop
from vqa_project_tpu.train.state import (create_train_state,
                                         make_optimizer as j_make_optimizer,
                                         save_checkpoint as j_save)
from vqa_project_tpu_torch.config import ModelConfig, TrainConfig
from vqa_project_tpu_torch.data import generate_synthetic_vqa
from vqa_project_tpu_torch.models import state_dict_from_jax_params
from vqa_project_tpu_torch.train import build_model, fit, make_optimizer
from vqa_project_tpu_torch.train.loop import _resume_checkpoint

GEN = dict(n_images=10, n_questions=80, n_obj=6, feat_dim=12, q_vocab=16,
           n_answers=8, seed=21)
MODEL = dict(hid_dim=16, combined_dim=8, n_kernels=4, neighbourhood_size=3,
             dropout=0.5, compute_dtype="float32")
BS, EMB = 12, 10          # 60 train questions: 5 steps an epoch


@pytest.fixture(scope="module")
def ds():
    return generate_synthetic_vqa(**GEN, emb_dim=EMB, max_qlen=8)


def _cfg(save_dir, epochs, eval_interval=0):
    return TrainConfig(lr=5e-3, epochs=epochs, batch_size=BS,
                       log_interval=1, eval_interval=eval_interval,
                       save_dir=save_dir, seed=4, lr_milestones=(1,),
                       lr_gamma=0.5)


def _fit(ds, save_dir, epochs, **kw):
    eval_interval = kw.pop("eval_interval", 0)
    jsonl = os.path.join(save_dir, "metrics.jsonl")
    model, optimizer, acc = fit(
        _cfg(save_dir, epochs, eval_interval=eval_interval),
        ModelConfig(**MODEL), ds["train"], ds["val"], device="cpu",
        jsonl_path=jsonl, **kw)
    with open(jsonl) as f:
        recs = {r["step"]: r for r in map(json.loads, f)}
    return model, recs


def _assert_same_run(got, want, first_step):
    (g_model, g_recs), (w_model, w_recs) = got, want
    assert sorted(g_recs) == [s for s in sorted(w_recs) if s >= first_step]
    for s, rec in g_recs.items():
        for key in ("epoch", "loss", "vqa_acc", "lr"):
            assert rec[key] == w_recs[s][key], (s, key)
    w_sd = w_model.state_dict()
    for k, v in g_model.state_dict().items():
        assert torch.equal(v, w_sd[k]), k


@pytest.fixture(scope="module")
def uninterrupted(ds, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("full"))
    run = _fit(ds, d, 2, save_every_epoch=True)
    assert sorted(run[1]) == list(range(1, 11))
    return d, run


def test_resume_at_the_epoch_boundary(ds, uninterrupted, tmp_path):
    d, want = uninterrupted
    payload = torch.load(os.path.join(d, "model_1.ckpt"), weights_only=True)
    assert payload["epoch"] == 1 and payload["step"] == 5
    assert payload["extra"]["step_in_epoch"] == 0
    got = _fit(ds, str(tmp_path), 1,
               resume_path=os.path.join(d, "model_1.ckpt"))
    _assert_same_run(got, want, 6)


def test_resume_mid_epoch(ds, uninterrupted, tmp_path):
    """A checkpoint written at a mini-validation after step 3 of epoch 1
    (by a run stopped there) finishes epoch 1 from batch 4, then runs
    epoch 2."""
    _, want = uninterrupted
    first = str(tmp_path / "first")
    _fit(ds, first, 1, eval_interval=3)
    ckpt = os.path.join(first, "model_1.ckpt")
    payload = torch.load(ckpt, weights_only=True)
    assert payload["extra"]["step_in_epoch"] == 3 and payload["step"] == 3
    got = _fit(ds, str(tmp_path / "second"), 2, resume_path=ckpt)
    _assert_same_run(got, want, 4)


def test_missing_and_msgpack_checkpoints_raise(ds, tmp_path):
    with pytest.raises(FileNotFoundError):
        _fit(ds, str(tmp_path), 1, resume_path=str(tmp_path / "nope.ckpt"))
    jcfg = JModelConfig(**MODEL, use_pallas=False, vocab_size=17,
                        emb_dim=EMB, feat_dim=16, out_dim=9, n_obj=6,
                        max_qlen=8)
    state = create_train_state(
        j_loop.GraphVQAModel(jcfg), jcfg, j_make_optimizer(JTrainConfig(),
                                                           5),
        _sample(jcfg), seed=1)
    msgpack = str(tmp_path / "jax.ckpt")
    j_save(msgpack, state, epoch=1)
    # the JAX-written file is read now: the run starts from its weights
    # at its next epoch and its step (0), with its Adam state
    model, recs = _fit(ds, str(tmp_path / "run"), 1, resume_path=msgpack)
    assert sorted(recs) == list(range(1, 6))
    assert {r["epoch"] for r in recs.values()} == {1}
    fresh = build_model(ModelConfig(**MODEL), ds["train"], device="cpu")
    optimizer, scheduler = make_optimizer(fresh, _cfg(str(tmp_path), 1), 5)
    _resume_checkpoint(msgpack, fresh, optimizer, scheduler, None)
    want = state_dict_from_jax_params(jax.device_get(state.params))
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), k


def _sample(cfg):
    return {"question": np.zeros((2, cfg.max_qlen), np.int32),
            "image": np.zeros((2, cfg.n_obj, cfg.feat_dim), np.float32),
            "qlen": np.ones((2,), np.int32)}


def _reference_order(names):
    """The reference's state_dict order: a weight-normed Linear registers
    bias before weight_g / weight_v."""
    out = []
    for n in names:
        if n.endswith(".weight_g"):
            out.append(n[:-len("weight_g")] + "bias")
        if not n.endswith(".bias") or n[:-len("bias")] + "weight_g" \
                not in names:
            out.append(n)
    return out


def _write_reference_pt(path, model, optimizer, epoch, naming):
    """The reference's full dict: weights in its key order (legacy or
    parametrize weight-norm names) and torch Adam state keyed by index
    in that order."""
    sd = model.state_dict()
    order = _reference_order(list(sd))
    assert sorted(order) == sorted(sd)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    index = {id(p): i for i, p in enumerate(params)}
    named = dict(model.named_parameters())
    state = {}
    for i, name in enumerate(order):
        s = optimizer.state[named[name]]
        state[i] = {k: v.clone() for k, v in s.items()}
    assert len(state) == len(index)

    def rename(k):
        if naming == "parametrize":
            k = (k.replace(".weight_g", ".parametrizations.weight.original0")
                  .replace(".weight_v", ".parametrizations.weight.original1"))
        return k

    torch.save({"epoch": epoch,
                "state_dict": collections.OrderedDict(
                    (rename(k), sd[k].clone()) for k in order),
                "optimizer": {"state": state, "param_groups": [
                    {"lr": 5e-3, "params": list(range(len(order)))}]}},
               path)


@pytest.fixture(scope="module")
def reference_setup(ds, tmp_path_factory):
    """A port model after one epoch (its Adam moments nonzero), and the
    JAX package's template state at the same widths."""
    d = str(tmp_path_factory.mktemp("jax_files"))
    j_gen(d, **GEN)
    jds = JDataset.vqa2(d, "train", emb_dim=EMB, n_obj=GEN["n_obj"],
                        max_qlen=8)
    model, optimizer, _ = fit(_cfg(d, 1), ModelConfig(**MODEL), ds["train"],
                              device="cpu")
    jmodel = j_loop.build_model(JModelConfig(**MODEL, use_pallas=False), jds)
    template = create_train_state(
        jmodel, jmodel.cfg, j_make_optimizer(JTrainConfig(lr=5e-3), 5),
        _sample(jmodel.cfg), seed=4)
    return model, optimizer, template


def _port_resume(ds, path):
    model = build_model(ModelConfig(**MODEL), ds["train"], device="cpu",
                        seed=99)
    optimizer, scheduler = make_optimizer(model, _cfg("", 1), 5)
    generator = torch.Generator().manual_seed(4)
    epoch, skip, step = _resume_checkpoint(path, model, optimizer,
                                           scheduler, generator)
    return model, optimizer, scheduler, (epoch, skip, step)


def _adam(opt_state):
    import optax
    return next(s for s in opt_state if isinstance(s, optax.ScaleByAdamState))


@pytest.mark.parametrize("naming", ["weight_norm", "parametrize"])
def test_reference_pt_resumes_as_jax_does(ds, reference_setup, tmp_path,
                                          naming):
    trained, trained_opt, template = reference_setup
    pt = str(tmp_path / "ref.pt")
    _write_reference_pt(pt, trained, trained_opt, 1, naming)
    model, optimizer, scheduler, (epoch, skip, step) = _port_resume(ds, pt)
    j_epoch, j_skip, j_state = j_loop._resume_checkpoint(pt, template)
    assert (epoch, skip) == (j_epoch, j_skip) == (1, 0)
    assert step == int(j_state.step) == 5
    want = state_dict_from_jax_params(jax.device_get(j_state.params))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    adam = _adam(j_state.opt_state)
    mu = state_dict_from_jax_params(jax.device_get(adam.mu))
    nu = state_dict_from_jax_params(jax.device_get(adam.nu))
    for name, p in model.named_parameters():
        s = optimizer.state[p]
        assert torch.equal(s["exp_avg"], mu[name]), name
        assert torch.equal(s["exp_avg_sq"], nu[name]), name
        assert float(s["step"]) == int(adam.count) == 5
    # the schedule stands at step 5: past the epoch-1 milestone
    assert scheduler.last_epoch == 5
    assert optimizer.param_groups[0]["lr"] == 5e-3 * 0.5


def test_reference_pt_with_disagreeing_steps_is_refused(ds, reference_setup,
                                                        tmp_path):
    trained, trained_opt, template = reference_setup
    pt = str(tmp_path / "ref.pt")
    _write_reference_pt(pt, trained, trained_opt, 1, "weight_norm")
    ckpt = torch.load(pt, weights_only=True)
    ckpt["optimizer"]["state"][3]["step"] = torch.tensor(4.0)
    torch.save(ckpt, pt)
    model, optimizer, scheduler, (epoch, _, step) = _port_resume(ds, pt)
    _, _, j_state = j_loop._resume_checkpoint(pt, template)
    assert step == int(j_state.step) == 0 and epoch == 1
    assert not optimizer.state                  # Adam starts fresh
    assert not np.asarray(_adam(j_state.opt_state).mu["params"]["wembed"]
                          ).any()
    assert scheduler.last_epoch == 0
    # the weights still load
    want = state_dict_from_jax_params(jax.device_get(j_state.params))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_fit_resumes_from_a_reference_pt(ds, reference_setup, tmp_path):
    """fit continues the reference's step count and epoch."""
    trained, trained_opt, _ = reference_setup
    pt = str(tmp_path / "ref.pt")
    _write_reference_pt(pt, trained, trained_opt, 1, "weight_norm")
    _, recs = _fit(ds, str(tmp_path / "run"), 1, resume_path=pt)
    assert sorted(recs) == list(range(6, 11))
    assert {r["epoch"] for r in recs.values()} == {1}
    shutil.rmtree(tmp_path / "run")


def test_reference_pt_with_an_index_past_its_weights_is_refused(
        ds, reference_setup, tmp_path):
    """Adam state for a parameter index the checkpoint's state_dict does
    not have: the optimizer starts fresh, the weights still load."""
    trained, trained_opt, _ = reference_setup
    pt = str(tmp_path / "ref.pt")
    _write_reference_pt(pt, trained, trained_opt, 1, "weight_norm")
    ckpt = torch.load(pt, weights_only=True)
    state = ckpt["optimizer"]["state"]
    state[len(ckpt["state_dict"])] = state.pop(0)
    torch.save(ckpt, pt)
    model, optimizer, _, (epoch, _, step) = _port_resume(ds, pt)
    assert (epoch, step) == (1, 0) and not optimizer.state
    for k, v in model.state_dict().items():
        assert torch.equal(v, trained.state_dict()[k]), k
