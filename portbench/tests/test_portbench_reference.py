"""The plain reference (portbench/reference/) held against the program's
CPU path (its plain versions) at small widths, in float32: the forward,
the training forward with dropout, the loss, the gradients and Adam's
steps. The test imports both; the reference imports neither the program
nor the harness."""

import numpy as np
import pytest
import torch

from portbench.harness.weights import make_weights
from portbench.reference.dropout import draw, philox_keep
from portbench.reference.model import Reference, dense_labels, soft_margin_loss
from portbench.reference.train import run_steps

M = dict(vocab_size=40, emb_dim=12, feat_dim=20, hid_dim=16, out_dim=23,
         combined_dim=10, n_kernels=4, neighbourhood_size=5, n_obj=9,
         dropout=0.3, max_qlen=7, compute_dtype="float32")
B = 6


def _model():
    from vqa_project_tpu_torch.config import ModelConfig
    from vqa_project_tpu_torch.models.graph_vqa import GraphVQAModel
    model = GraphVQAModel(ModelConfig(**M), device="cpu", seed=0)
    w = make_weights(M, 11, "cpu")
    model.load_state_dict(w)
    return model, w


def _inputs(seed=3):
    g = torch.Generator().manual_seed(seed)
    qlen = torch.randint(1, M["max_qlen"] + 1, (B,), generator=g)
    q = torch.randint(1, M["vocab_size"], (B, M["max_qlen"]), generator=g)
    q[torch.arange(M["max_qlen"])[None, :] >= qlen[:, None]] = 0
    feats = torch.rand((B, M["n_obj"], M["feat_dim"] - 4), generator=g)
    xy = torch.rand((B, M["n_obj"], 2), generator=g) * 0.5
    boxes = torch.cat([xy, xy + 0.1 + 0.3 * torch.rand(
        (B, M["n_obj"], 2), generator=g)], -1)
    return q, qlen, feats, boxes


@pytest.fixture(autouse=True)
def _flush_denormals():
    old = torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(old)


def test_weights_are_the_models_state_dict():
    model, w = _model()
    sd = model.state_dict()
    assert set(sd) == set(w)
    for k in w:
        assert sd[k].shape == w[k].shape and torch.equal(sd[k], w[k])


def test_eval_forward_matches_the_program():
    model, w = _model()
    q, qlen, feats, boxes = _inputs()
    want, _, _ = model(q, (feats, boxes), qlen)
    got = Reference(M).forward(w, q, qlen, feats, boxes)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_philox_matches_the_programs_bits():
    from vqa_project_tpu_torch.ops.dropout import philox_keep as program
    seeds = torch.tensor([0, 1, 2 ** 31 - 2, 123456789], dtype=torch.int32)
    assert torch.equal(philox_keep(seeds, (3, 50), 0.4),
                       program(seeds, (3, 50), 0.4))


def test_training_forward_loss_and_gradients_match_the_program():
    model, w = _model()
    q, qlen, feats, boxes = _inputs(5)
    gen_p = torch.Generator().manual_seed(77)
    logits_p, _, _ = model(q, (feats, boxes), qlen, train=True,
                           generator=gen_p)
    idx = torch.randint(0, M["out_dim"] - 1, (B, 3))
    val = torch.rand((B, 3))
    answers = dense_labels(idx, val, M["out_dim"])
    mask = torch.tensor([1, 1, 1, 1, 0, 1], dtype=torch.float32)
    from vqa_project_tpu_torch.ops.losses import multilabel_soft_margin_loss
    loss_p = multilabel_soft_margin_loss(logits_p, answers, mask)
    loss_p.backward()

    ref = Reference(M)
    wr = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    d = draw(torch.Generator().manual_seed(77), B, M["n_obj"], M["feat_dim"],
             M["out_dim"], M["dropout"], "cpu")
    logits_r = ref.forward(wr, q, qlen, feats, boxes, d)
    torch.testing.assert_close(logits_r, logits_p, rtol=1e-5, atol=1e-5)
    loss_r = soft_margin_loss(logits_r, answers, mask)
    torch.testing.assert_close(loss_r, loss_p, rtol=1e-6, atol=1e-7)
    loss_r.backward()
    for n, p in model.named_parameters():
        torch.testing.assert_close(wr[n].grad, p.grad, rtol=2e-4, atol=1e-7,
                                   msg=n)


def test_adam_steps_match_the_program():
    from vqa_project_tpu_torch.config import TrainConfig
    from vqa_project_tpu_torch.train.state import make_optimizer
    from vqa_project_tpu_torch.train.steps import train_step
    model, w = _model()
    optimizer, scheduler = make_optimizer(model, TrainConfig(lr=1e-2), 100)
    gen = torch.Generator().manual_seed(9)
    batches = []
    for s in range(3):
        q, qlen, feats, boxes = _inputs(20 + s)
        idx = torch.randint(0, M["out_dim"] - 1, (B, 16))
        val = torch.rand((B, 16))
        answers = dense_labels(idx, val, M["out_dim"])
        image = torch.cat([feats, boxes], -1)
        train_step(model, optimizer, scheduler, {
            "question": q.numpy(), "image": image.numpy(),
            "qlen": qlen.numpy(), "answers": answers.numpy(),
            "votes": np.zeros_like(answers.numpy()),
            "mask": np.ones(B, np.float32)}, gen)
        batches.append({"question": q, "qlen": qlen, "feats": feats,
                        "boxes": boxes, "answers": answers,
                        "mask": torch.ones(B)})
    losses, grad1, change, logits1 = run_steps(Reference(M), w, batches,
                                               1e-2, M["dropout"], 9, "cpu")
    assert len(losses) == 3 and grad1 and logits1.shape == (B, M["out_dim"])
    for n, p in model.named_parameters():
        torch.testing.assert_close(change[n], p.detach() - w[n], rtol=1e-3,
                                   atol=1e-6, msg=n)


def test_fp8_control_rounds_its_products():
    ref, low = Reference(M), Reference(M, "fp8")
    _, w = _model()
    q, qlen, feats, boxes = _inputs()
    a = ref.forward(w, q, qlen, feats, boxes)
    b = low.forward(w, q, qlen, feats, boxes)
    assert not torch.allclose(a, b, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(a, b, rtol=0.5, atol=0.5)
