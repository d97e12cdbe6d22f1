"""Nemotron-H's hybrid decoder (models/nemotron_h.py) on the CPU, at
small widths, against the benchmark's plain reference
(portbench/reference/nemotron_h.py): logits, loss and every gradient,
the chunked scan against the recurrence, left padding, the expert share,
three Adam steps, fit / checkpoint / evaluate, the CLI, and the uncut
model's parameter count."""

import json
import os

import numpy as np
import pytest
import torch

from portbench.harness import checks
from portbench.harness.nemotron import make_weights, n_params, program_config
from portbench.reference.nemotron_h import (NemotronHReference,
                                            route_mismatch, run_steps)
from vqa_project_tpu_torch.config import ModelConfig, TrainConfig
from vqa_project_tpu_torch.data import generate_synthetic_vqa
from vqa_project_tpu_torch.data.feature_cache import RegionCache
from vqa_project_tpu_torch.models import NemotronHModel, make_model
from vqa_project_tpu_torch.models.nemotron_h import MoE
from vqa_project_tpu_torch.ops import moe as moe_ops
from vqa_project_tpu_torch.ops.gather_rows import RegionImage
from vqa_project_tpu_torch.ops.ssd import ssd
from vqa_project_tpu_torch.train import (build_model, evaluate, fit,
                                         load_checkpoint, make_optimizer,
                                         save_checkpoint)
from vqa_project_tpu_torch.train.steps import make_image_fn, train_step

# the benchmark's sizes (harness/nemotron.py::spec's keys) at small widths
M = {"hybrid_override_pattern": "MEM*EME*", "num_hidden_layers": 8,
     "hidden_size": 32, "mamba_num_heads": 4, "mamba_head_dim": 8,
     "ssm_state_size": 8, "n_groups": 2, "conv_kernel": 4, "chunk_size": 8,
     "time_step_min": 0.001, "time_step_max": 0.1, "time_step_floor": 1e-4,
     "router_experts": 16, "n_routed_experts": 4, "first_held_expert": 4,
     "num_experts_per_tok": 3, "moe_intermediate_size": 24,
     "moe_shared_expert_intermediate_size": 40, "routed_scaling_factor": 2.5,
     "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 8,
     "layer_norm_epsilon": 1e-5, "initializer_range": 0.02,
     "vocab_size": 50, "img_feat_size": 20, "img_feat_pad_size": 6,
     "max_token": 5, "answer_size": 11, "regions": [1, 6],
     "compute_dtype": "float32"}
B = 5


@pytest.fixture(autouse=True)
def _flush_denormals():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _model(m=M, seed=11, weights_seed=7):
    model = NemotronHModel(ModelConfig(**program_config(m)), device="cpu",
                           seed=seed)
    w = make_weights(m, weights_seed, "cpu")
    # larger weights than N(0, 0.02), so that every path moves the logits
    w = {k: v * 10 if v.dim() >= 2 and "conv1d" not in k else v
         for k, v in w.items()}
    model.load_state_dict(w)
    return model, w


def _inputs(seed=3, k=M["img_feat_pad_size"], t=M["max_token"]):
    g = torch.Generator().manual_seed(seed)
    counts = torch.randint(1, M["img_feat_pad_size"] + 1, (B,), generator=g)
    feats = torch.rand(B, k, M["img_feat_size"], generator=g)
    feats[torch.arange(k)[None, :] >= counts[:, None]] = 0.0
    qlen = torch.randint(1, M["max_token"] + 1, (B,), generator=g)
    q = torch.randint(1, M["vocab_size"], (B, t), generator=g)
    q[torch.arange(t)[None, :] >= qlen[:, None]] = 0
    return q, feats, counts


def _close(got, want, rtol=1e-5):
    scale = max(float(want.abs().max()), 1e-12)
    assert float((got - want).abs().max()) <= rtol * scale, (
        float((got - want).abs().max()), scale)


def test_weights_are_the_models_state_dict_and_count():
    model, w = _model()
    sd = model.state_dict()
    assert set(sd) == set(w)
    assert all(sd[k].shape == w[k].shape for k in w)
    assert sum(p.numel() for p in model.parameters()) == n_params(M)


def test_make_model_picks_the_architecture():
    cfg = ModelConfig(**program_config(M))
    assert isinstance(make_model(cfg, device="cpu"), NemotronHModel)
    with pytest.raises(ValueError, match="unknown nemotron_h sizes"):
        NemotronHModel(ModelConfig(**{**program_config(M),
                                      "arch_sizes": {"hidden": 3}}),
                       device="cpu")


def test_training_logits_loss_and_every_gradient_match_the_reference():
    model, w = _model()
    q, feats, counts = _inputs()
    labels = torch.rand(B, M["answer_size"])
    logits, _, _ = model(q, RegionImage(feats, counts), None, train=True)
    loss = model.loss(logits, torch.cat([labels, torch.zeros(B, 1)], 1))
    loss.backward()
    ref = NemotronHReference(M)
    wr = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    rlogits, _ = ref.forward(wr, q, feats, counts)
    from portbench.reference.mcan import bce_sum
    rloss = bce_sum(rlogits, labels, torch.ones(B))
    _close(logits, rlogits.detach())
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    rgrads = torch.autograd.grad(rloss, list(wr.values()), allow_unused=True)
    named = dict(model.named_parameters())
    for name, g in zip(wr, rgrads):
        if name not in named:
            continue                      # the correction bias, a buffer
        _close(named[name].grad, g, rtol=2e-4)


def _sequential(x, dt, A, Bm, Cm):
    b, length, nh, p = x.shape
    g, n = Bm.shape[2:]
    bh = Bm.repeat_interleave(nh // g, dim=2)
    ch = Cm.repeat_interleave(nh // g, dim=2)
    s = torch.zeros(b, nh, p, n, dtype=torch.float64)
    ys = []
    for t in range(length):
        s = (torch.exp(dt[:, t] * A)[..., None, None] * s
             + (dt[:, t, :, None] * x[:, t])[..., None] * bh[:, t][:, :, None])
        ys.append(torch.einsum("bhpn,bhn->bhp", s, ch[:, t]))
    return torch.stack(ys, 1)


@pytest.mark.parametrize("length,chunk", [(13, 32), (13, 4), (16, 8),
                                          (17, 5)])
def test_the_chunked_scan_is_the_recurrence(length, chunk):
    g = torch.Generator().manual_seed(length * chunk)
    b, nh, p, gr, n = 2, 4, 3, 2, 5
    x = torch.randn(b, length, nh, p, generator=g)
    dt = torch.rand(b, length, nh, generator=g) * 0.5
    dt[0, 3] = 0.0                     # a position that leaves the state
    A = -torch.rand(nh, generator=g) * 3
    Bm = torch.randn(b, length, gr, n, generator=g)
    Cm = torch.randn(b, length, gr, n, generator=g)
    got = ssd(x, dt, A, Bm, Cm, chunk, torch.float32)
    want = _sequential(*(t.double() for t in (x, dt, A, Bm, Cm)))
    _close(got.double(), want, rtol=1e-5)
    # bf16 operands, f32 sums: the error of one bf16 rounding
    low = ssd(x, dt, A, Bm, Cm, chunk, torch.bfloat16)
    _close(low.double(), want, rtol=3e-2)


def test_the_chunked_scan_differentiates_as_the_recurrence():
    g = torch.Generator().manual_seed(5)
    args = [torch.randn(2, 11, 4, 3, generator=g),
            torch.rand(2, 11, 4, generator=g) * 0.5,
            -torch.rand(4, generator=g) * 2,
            torch.randn(2, 11, 2, 5, generator=g),
            torch.randn(2, 11, 2, 5, generator=g)]
    a = [t.clone().requires_grad_(True) for t in args]
    b = [t.double().requires_grad_(True) for t in args]
    ssd(*a, 4, torch.float32).pow(2).sum().backward()
    _sequential(*b).pow(2).sum().backward()
    for x, y in zip(a, b):
        _close(x.grad.double(), y.grad, rtol=1e-4)


def test_left_padding_changes_no_logit():
    """The same sequences, left-padded to 6 + 5 and to 9 + 8 positions,
    give the same logits, and the reference's unpadded ones."""
    model, w = _model()
    q, feats, counts = _inputs()
    small, _, _ = model(q, RegionImage(feats, counts), None)
    wide_q = torch.cat([q, torch.zeros(B, 3, dtype=q.dtype)], 1)
    wide_f = torch.cat([feats, torch.zeros(B, 3, feats.shape[2])], 1)
    wide, _, _ = model(wide_q, RegionImage(wide_f, counts), None)
    _close(wide, small)
    ref, _ = NemotronHReference(M).forward(w, q, feats, counts)
    _close(small, ref)


@pytest.mark.parametrize("image", ["dense", "pair"])
def test_host_images_find_their_live_regions(image):
    model, _ = _model()
    q, feats, counts = _inputs()
    want, _, _ = model(q, RegionImage(feats, counts), None)
    boxes = torch.rand(B, feats.shape[1], 4)
    img = (torch.cat([feats, boxes], -1) if image == "dense"
           else (feats, boxes))
    got, _, _ = model(q, img, None)
    _close(got, want)


def test_eight_expert_shares_add_up_to_the_uncut_layer():
    """Under 8-way expert parallelism each card's partial output (its 2
    of 16 experts) plus, once, the shared expert is the uncut layer's
    (the reference's, every expert held)."""
    m = {**M, "n_routed_experts": 16, "first_held_expert": 0}
    uncut, w = _model(m)
    layer = next(l.mixer for l in uncut.backbone.layers if l.kind == "E")
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 7, M["hidden_size"], generator=g)
    live = torch.ones(3, 7, dtype=torch.bool)
    live[0, :2] = False
    idx, wts = layer.gate(x.reshape(21, -1))
    parts, held = [], 0
    for card in range(8):
        part, counts = moe_ops.held_experts(
            x.reshape(21, -1), idx, wts, live.reshape(-1),
            layer.experts.up_proj[2 * card:2 * card + 2],
            layer.experts.down_proj[2 * card:2 * card + 2], 2 * card,
            torch.float32)
        parts.append(part)
        held += int(counts[:-1].sum())
    # every live pair is held by one card
    assert held == 19 * 3
    whole = sum(parts) + layer.shared_experts(x.reshape(21, -1))
    got = layer(x, live).reshape(21, -1)
    _close(got, whole)
    ref = NemotronHReference(m)
    p = next(f"backbone.layers.{i}.mixer" for i, k in
             enumerate(m["hybrid_override_pattern"]) if k == "E")
    want, ridx = ref.moe(w, p, x)
    live_rows = live.reshape(-1)
    _close(got[live_rows], want.reshape(21, -1)[live_rows])
    assert torch.equal(ridx.reshape(21, -1)[live_rows], idx[live_rows])


def test_dispatch_sorts_pads_and_counts():
    idx = torch.tensor([[4, 5], [7, 4], [1, 6], [5, 4]])
    w = torch.arange(8, dtype=torch.float32).view(4, 2) + 1
    live = torch.tensor([True, True, True, False])
    row_token, row_weight, pair_row, offsets, counts = moe_ops.dispatch(
        idx, w, live, 4, 3)
    assert counts.tolist() == [2, 1, 1, 4]        # 4, 5, 6 held; the rest
    a = moe_ops.ALIGN
    assert offsets.tolist() == [0, a, 2 * a, 3 * a]
    assert row_token.shape[0] == moe_ops.capacity(8, 3)
    assert row_token[:2].tolist() == [0, 1] and row_token[2] == 4
    assert row_weight[:2].tolist() == [1.0, 4.0]
    assert row_token[a].item() == 0 and row_weight[a].item() == 2.0
    assert row_token[2 * a].item() == 2 and row_weight[2 * a].item() == 6.0
    assert (row_weight != 0).sum() == 4
    cap = row_token.shape[0]
    assert pair_row.tolist() == [0, a, cap, 1, cap, 2 * a, cap, cap]


@pytest.mark.parametrize("layout", ["nt", "nn", "tn"])
def test_the_grouped_product_loops_over_its_groups(layout):
    g = torch.Generator().manual_seed(1)
    off = torch.tensor([0, 3, 3, 7], dtype=torch.int32)
    a = torch.randn(8, 5, generator=g).bfloat16()
    if layout == "tn":
        b = torch.randn(8, 4, generator=g).bfloat16()
        got, _ = moe_ops.grouped_gemm(a, b, off, "tn")
        assert torch.equal(got[1], torch.zeros(5, 4))
        _close(got[2], a[3:7].float().t() @ b[3:7].float())
    else:
        b = torch.randn(3, 4, 5, generator=g).bfloat16()
        if layout == "nn":
            b = b.transpose(1, 2).contiguous()
        got, _ = moe_ops.grouped_gemm(a, b, off, layout)
        w2 = b[2].float() if layout == "nn" else b[2].float().t()
        _close(got[3:7], a[3:7].float() @ w2)
        assert torch.equal(got[7], torch.zeros(4))


def _index_batches(feats, counts, q, labels, n):
    """n index batches over the rows of a region table of B images."""
    out = []
    for _ in range(n):
        ans_idx = np.full((B, 4), M["answer_size"], np.int32)
        ans_score = np.zeros((B, 4), np.float32)
        top = labels.argmax(-1).numpy()
        ans_idx[:, 0] = top
        ans_score[:, 0] = 1.0
        out.append({"question": q.numpy().astype(np.int32),
                    "qlen": (q != 0).sum(-1).numpy().astype(np.int32),
                    "image_row": np.arange(B, dtype=np.int32),
                    "ans_idx": ans_idx, "ans_score": ans_score,
                    "vote_idx": ans_idx.copy(),
                    "vote_val": ans_score * 3,
                    "mask": np.ones(B, np.float32)})
    return out


def test_three_train_steps_match_the_reference():
    model, w = _model()
    q, feats, counts = _inputs()
    labels = torch.rand(B, M["answer_size"])
    tcfg = TrainConfig(lr=1e-3, batch_size=B)
    optimizer, _ = make_optimizer(model, tcfg, 10)
    image_fn = make_image_fn(RegionCache(feats, counts.int()), "float32")
    batches = _index_batches(feats, counts, q, labels, 3)
    losses, seen = [], []
    for batch in batches:
        out = train_step(model, optimizer, None, batch, None, image_fn)
        losses.append(float(out["loss"]))
        seen.append({k: float(v) for k, v in out.items()})
    # the MoE row counts ride with the step's results
    # three MoE blocks, three slots a live position
    assert seen[0]["moe.routed_rows"] == 3 * 3 * int(
        (counts + (q != 0).sum(-1)).sum())
    assert 0 < seen[0]["moe.held_rows"] <= seen[0]["moe.routed_rows"]
    dense = torch.zeros(B, M["answer_size"])
    dense[torch.arange(B), labels.argmax(-1)] = 1.0
    ref_batch = {"question": q, "feats": feats, "counts": counts,
                 "answers": dense, "mask": torch.ones(B)}
    (r_losses, grad1, change, _), routes = run_steps(
        NemotronHReference(M), w, [ref_batch] * 3, 1e-3, rows_at_once=2)
    assert losses == pytest.approx(r_losses, rel=1e-5)
    # the cell's comparison of the change (Adam moves an element whose
    # gradient is rounding noise by lr either way, so leaves are compared
    # by their norms, the still ones left out)
    mine = {n: p.detach() - w[n] for n, p in model.named_parameters()}
    gaps = checks.leaf_gaps(mine, change, checks.moving_leaves(grad1))
    assert max(gaps.values()) < 1e-3, max(gaps.items(), key=lambda kv: kv[1])
    assert len(routes) == 3 and len(routes[0]) == B


def test_route_mismatch_counts_the_choices_that_differ():
    prog = [torch.tensor([[[0, 0], [1, 2], [3, 4]]])]
    ref = [[torch.tensor([[1, 2], [4, 5]])]]
    assert route_mismatch(prog, ref, torch.tensor([2])) == 0.25


@pytest.fixture(scope="module")
def synthetic():
    return generate_synthetic_vqa(n_images=10, n_questions=48, n_obj=6,
                                  feat_dim=12, emb_dim=8, max_qlen=14,
                                  n_answers=10, with_test=True)


SIZES = {"num_hidden_layers": 4, "hybrid_override_pattern": "ME*M",
         "mamba_num_heads": 2, "mamba_head_dim": 8, "ssm_state_size": 4,
         "n_groups": 1, "chunk_size": 16, "n_routed_experts": 8,
         "n_held_experts": 4, "num_experts_per_tok": 2,
         "moe_intermediate_size": 8, "moe_shared_expert_intermediate_size": 8,
         "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 8}
MCFG = dict(arch="nemotron_h", hid_dim=16, compute_dtype="float32",
            arch_sizes=SIZES)


def test_fit_checkpoint_round_trip_and_evaluate(synthetic, tmp_path):
    train_ds, val_ds = synthetic["train"], synthetic["val"]
    tcfg = TrainConfig(epochs=1, batch_size=8, log_interval=2,
                       eval_interval=4, save_dir=str(tmp_path), seed=3)
    model, optimizer, acc = fit(tcfg, ModelConfig(**MCFG), train_ds, val_ds,
                                device="cpu")
    assert isinstance(model, NemotronHModel) and np.isfinite(acc)
    path = tmp_path / "m.ckpt"
    save_checkpoint(str(path), model, optimizer, step=3, model_cfg=model.cfg,
                    train_cfg=tcfg)
    fresh = build_model(ModelConfig(**MCFG), train_ds, device="cpu", seed=9)
    payload = load_checkpoint(str(path), fresh)
    assert payload["model_config"]["arch"] == "nemotron_h"
    assert payload["model_config"]["arch_sizes"] == SIZES
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
    acc2, result2, _ = evaluate(fresh, val_ds, 8, result_path=None,
                                cache=None, device="cpu")
    assert result2 == result and acc2 == pytest.approx(acc)


def test_cli_trains_and_evaluates_nemotron_h(tmp_path, monkeypatch):
    from vqa_project_tpu_torch.cli import run as cli
    monkeypatch.chdir(tmp_path)
    sizes = [f"{k}={v}" for k, v in SIZES.items()]
    common = ["--arch", "nemotron_h", "--synthetic", "--data_dir", "data",
              "--device", "cpu", "--hid", "16", "--emb", "8", "--n_obj", "6",
              "--bsize", "8", "--compute_dtype", "float32",
              "--synthetic_questions", "48", "--synthetic_images", "8",
              "--synthetic_feat_dim", "12", "--arch_sizes", *sizes]
    cli.main(["--train", "--ep", "1", "--save_dir", "save",
              "--log_interval", "2", "--eval_interval", "100"] + common)
    assert os.path.exists("save/model_1.ckpt")
    cli.main(["--eval", "--model_path", "save/model_1.ckpt"] + common)
    assert json.loads(open("result.json").read())


def test_the_uncut_model_counts_the_published_parameters():
    """The 52-block model at the published widths, built on the meta
    device: its backbone and an LM head over the 131,072-word vocabulary
    (the classifier's place) hold 31.58 B parameters, within 0.5% of the
    published 31.6 B."""
    cfg = ModelConfig(arch="nemotron_h", vocab_size=131072, hid_dim=2688,
                      feat_dim=2052, out_dim=3130, n_obj=100, max_qlen=14)
    with torch.device("meta"):
        model = NemotronHModel(cfg, device="meta")
    kinds = "".join(layer.kind for layer in model.backbone.layers)
    assert [kinds.count(k) for k in "ME*"] == [23, 23, 6]
    total = (sum(p.numel() for p in model.backbone.parameters())
             + 131072 * 2688)
    assert abs(total - 31.6e9) / 31.6e9 < 0.005, total
    assert round(total / 1e9, 2) == 31.58
    moe = next(layer.mixer for layer in model.backbone.layers
               if layer.kind == "E")
    assert isinstance(moe, MoE) and moe.experts.up_proj.shape == (
        128, 1856, 2688)


# ---------------- on the card (marker ``cuda``; skipped without one; run
# there with ``python -m pytest --noconftest -m cuda
# tests/test_torch_nemotron_h.py``) ----------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout,epilogue", [
    ("nt", "relu2"), ("nt", "f32"), ("nn", "dact"), ("nn", "f32"),
    ("tn", "f32")])
def test_the_grouped_kernel_is_its_loop_on_the_card(card, layout,
                                                    epilogue):
    """Uneven groups padded to ALIGN, one empty, unused rows past the last
    group: every layout and epilogue of the kernel against the loop."""
    g = torch.Generator().manual_seed(4)
    sizes = [200, 0, 57, 300]
    off = [0]
    for n in sizes:
        off.append(off[-1] + -(-n // moe_ops.ALIGN) * moe_ops.ALIGN)
    rows, k, n = off[-1] + 64, 256, 192
    live = torch.zeros(rows, 1, dtype=torch.bool)
    for e, size in enumerate(sizes):
        live[off[e]:off[e] + size] = True
    offsets = torch.tensor(off, dtype=torch.int32, device=card)

    def rows_of(width):
        t = torch.randn(rows, width, generator=g) * live
        return t.to(card, torch.bfloat16)

    a = rows_of(k)
    if layout == "tn":
        b = rows_of(n)
    elif layout == "nt":
        b = torch.randn(4, n, k, generator=g).to(card, torch.bfloat16)
    else:
        b = torch.randn(4, k, n, generator=g).to(card, torch.bfloat16)
    gate = rows_of(n).abs() if epilogue == "dact" else None
    got, aux = moe_ops.grouped_gemm(a, b, offsets, layout, epilogue, gate)
    want, want_aux = moe_ops.grouped_gemm_reference(a, b, offsets, layout,
                                                    epilogue, gate)
    torch.cuda.synchronize()
    if layout != "tn":
        got, want = got[:off[-1]], want[:off[-1]]
        if aux is not None:
            aux, want_aux = aux[:off[-1]], want_aux[:off[-1]]
    tol = 1e-5 if got.dtype == torch.float32 else 8e-3
    _close(got.float(), want.float(), rtol=tol)
    if aux is not None:
        _close(aux.float(), want_aux.float(), rtol=8e-3)
    if layout == "tn":
        assert torch.equal(got[1], torch.zeros_like(got[1]))


@pytest.mark.cuda
def test_graphed_nemotron_steps_equal_eager_steps(card):
    """Four steps of a small bf16 Nemotron-H on the card: replayed as the
    step's CUDA graph from the second, and all eager (a forward hook on
    the model keeps every step eager): the same losses, row counts and
    parameters, bit for bit; the grouped kernel launches 6 times a MoE
    block a step either way."""
    m = {**M, "hidden_size": 64, "mamba_num_heads": 4, "mamba_head_dim": 16,
         "ssm_state_size": 16, "n_groups": 2, "num_attention_heads": 4,
         "head_dim": 16, "moe_intermediate_size": 64,
         "moe_shared_expert_intermediate_size": 64, "img_feat_size": 64,
         "compute_dtype": "bfloat16"}
    q, feats, counts = _inputs()
    feats = torch.rand(B, M["img_feat_pad_size"], 64,
                       generator=torch.Generator().manual_seed(8))
    feats[torch.arange(feats.shape[1])[None, :] >= counts[:, None]] = 0.0
    labels = torch.rand(B, M["answer_size"])
    batches = _index_batches(feats, counts, q, labels, 4)

    def run(eager):
        model = NemotronHModel(ModelConfig(**program_config(m)), device=card,
                               seed=5)
        optimizer, _ = make_optimizer(model, TrainConfig(lr=1e-3), 10)
        hook = (model.register_forward_hook(lambda *a: None) if eager
                else None)
        image_fn = make_image_fn(RegionCache(
            feats.to(card, torch.bfloat16), counts.to(card, torch.int32)),
            "bfloat16")
        before = moe_ops.grouped_gemm.launches
        outs = [{k: float(v) for k, v in train_step(
            model, optimizer, None, b, None, image_fn).items()}
            for b in batches]
        launches = moe_ops.grouped_gemm.launches - before
        if hook is not None:
            hook.remove()
        return outs, model.state_dict(), launches

    eager, eager_state, eager_launches = run(True)
    graphed, state, launches = run(False)
    assert graphed == eager
    assert launches == eager_launches == 4 * 6 * 3
    for name, value in eager_state.items():
        assert torch.equal(state[name], value), name
