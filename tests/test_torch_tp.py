"""Tensor parallelism in the port (``parallel/tp.py``, ``--tp``) on the
CPU, against the JAX package's ``parallel/tp.py`` and against the port's
own data-parallel and one-process runs.

Without a process group: the (data, model) coordinates and refusals of
``make_mesh_2d`` against JAX's, ``param_spec`` and the shards' rows on
the port's names against JAX's ``param_spec`` and ``shard_state`` mapped
through the name map (divisible widths, odd widths, and a conv width
whose n·d divides tp while n does not), the bf16-reduce and feature
cache rules of a model axis, and the step's refusal of a plain
optimizer. Then two launches of gloo processes (tests/_torch_dp_child.py)
on the synthetic files at JAX's tp-test widths (vocabulary 20, 8
answers), both starting from one JAX-written initial checkpoint:

- 2 ranks: dp 2 (tp 1), dp 1 x tp 2, and the one-process path on every
  rank, with dropout on, checkpoints written at tp 2 and resumed at
  tp 1, and the other way round;
- 4 ranks: dp 2 x tp 2 (replicated cache, host mode, dropout on),
  ``evaluate`` over the 2-D mesh, and the mesh refusals inside a group.

dp 1 x tp 2 equals one process bit for bit, dp 2 x tp 2 equals dp 2 bit
for bit (the data group's sum is dp 2's, the slices, Adam and the
all-gather are exact) and stays within JAX's own tolerance (rtol 2e-4,
atol 2e-5; tests/test_tp.py) of JAX's ``fit(tp=2, num_devices=4)``.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests._torch_dp_child import ROOT, launch
from vqa_project_tpu.config import ModelConfig as JModelConfig
from vqa_project_tpu.config import TrainConfig as JTrainConfig
from vqa_project_tpu.data import GraphVQADataset as JDataset
from vqa_project_tpu.data.synthetic import generate_synthetic_vqa as j_gen
from vqa_project_tpu.models.graph_vqa import GraphVQAModel as JModel
from vqa_project_tpu.parallel import make_mesh_2d as j_make_mesh_2d
from vqa_project_tpu.parallel import shard_state as j_shard_state
from vqa_project_tpu.parallel.tp import param_spec as j_param_spec
from vqa_project_tpu.train import loop as j_loop
from vqa_project_tpu.train.state import create_train_state
from vqa_project_tpu.train.state import make_optimizer as j_make_optimizer
from vqa_project_tpu.train.state import save_checkpoint as j_save
from vqa_project_tpu.train.steps import \
    supports_bf16_reduce as j_supports_bf16
from vqa_project_tpu_torch.config import ModelConfig, TrainConfig
from vqa_project_tpu_torch.data import Batcher, GraphVQADataset
from vqa_project_tpu_torch.models import state_dict_from_jax_params
from vqa_project_tpu_torch.parallel import (Mesh, make_mesh, make_mesh_2d,
                                            param_spec)
from vqa_project_tpu_torch.parallel.tp import shard_rows
from vqa_project_tpu_torch.train import build_model, make_optimizer
from vqa_project_tpu_torch.train.loop import make_feature_cache
from vqa_project_tpu_torch.train.steps import (supports_bf16_reduce,
                                               train_step)

CPU = torch.device("cpu")
N_OBJ, QLEN, BS, EPOCH_STEPS = 8, 10, 32, 6
# vocabulary 20 and 8 answers (q_vocab + 1, n_answers + 1): every rule
# engages at tp = 2, as in tests/test_tp.py
GEN = dict(n_images=16, n_questions=256, n_obj=N_OBJ, feat_dim=24,
           q_vocab=19, n_answers=7)
MODEL = dict(hid_dim=32, combined_dim=16, n_kernels=4, neighbourhood_size=4,
             dropout=0.0, compute_dtype="float32")
TRAIN = dict(lr=1e-3, epochs=1, batch_size=BS, log_interval=2,
             eval_interval=0, seed=1000)
# two mini-validations an epoch (6 steps)
VAL = {"with_val": True, "train": {**TRAIN, "eval_interval": 3}}
# dropout on, checkpoints at step 4 of each of two epochs
DROP = {"model": {**MODEL, "dropout": 0.5}, "with_val": True,
        "train": {**TRAIN, "epochs": 2, "eval_interval": 4}}
HOST = {"device_cache_bytes": 0}


@pytest.fixture(autouse=True)
def flush_denormals():
    """XLA:CPU flushes denormals; run torch's CPU kernels the same way
    (see tests/test_torch_model.py)."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _jds(d, split):
    return JDataset.vqa2(d, split, n_obj=N_OBJ, max_qlen=QLEN)


def _pds(d, split):
    return GraphVQADataset.vqa2(d, split, 300, N_OBJ, QLEN)


def _tp(leg, tp=2):
    return {**leg, "train": {**leg["train"], "tp": tp}}


def _fit(name, leg, **extra):
    return {"name": name, "kind": "fit", "model": MODEL, **leg, **extra}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The synthetic files, JAX's initial state as a checkpoint at epoch
    0, and the reports of the 2-rank and the 4-rank launch."""
    root = tmp_path_factory.mktemp("tp")
    d = str(root / "data")
    j_gen(d, **GEN)
    jds = _jds(d, "train")
    jmodel = j_loop.build_model(JModelConfig(**MODEL, use_pallas=False), jds)
    sample = {"question": np.zeros((2, QLEN), np.int32),
              "image": np.zeros((2, N_OBJ, jds.feat_dim), np.float32),
              "qlen": np.ones((2,), np.int32)}
    state = create_train_state(jmodel, jmodel.cfg, j_make_optimizer(
        JTrainConfig(lr=TRAIN["lr"]), EPOCH_STEPS), sample, 1000)
    init = str(root / "jax_init.ckpt")
    j_save(init, state, epoch=0)
    two, four = str(root / "two"), str(root / "four")
    base = {"data_dir": d, "n_obj": N_OBJ, "max_qlen": QLEN}
    plain = {"train": TRAIN, "resume": init}
    host = {"train": {**TRAIN, **HOST}, "resume": init}
    legs_two = [
        _fit("dp2", {**VAL, "resume": init}),
        _fit("dp2_dropout", DROP),
        _fit("dp2_host", host),
        _fit("alone", plain, alone=True),
        _fit("tp2", _tp(plain)),
        _fit("alone_dropout", DROP, alone=True),
        _fit("tp2_dropout", _tp(DROP)),
        _fit("tp2_from_alone", _tp(DROP), resume=os.path.join(
            two, "alone_dropout", "rank0", "model_1.ckpt")),
        _fit("alone_from_tp2", DROP, alone=True, resume=os.path.join(
            two, "tp2_dropout", "rank0", "model_1.ckpt")),
    ]
    reports_two = launch({**base, "legs": legs_two}, two, n=2, timeout=420)
    evaluate = {"kind": "evaluate", "model": MODEL, "weights": "dp2tp2",
                "batch_size": BS}
    legs_four = [
        _fit("dp2tp2", _tp({**VAL, "resume": init})),
        _fit("dp2tp2_dropout", _tp(DROP)),
        _fit("dp2tp2_host", _tp(host)),
        {**evaluate, "name": "evaluate_dp"},
        {**evaluate, "name": "evaluate_tp", "tp": 2},
        {**evaluate, "name": "evaluate_dp_host", "adjacency": True,
         "train": HOST},
        {**evaluate, "name": "evaluate_tp_host", "adjacency": True,
         "train": HOST, "tp": 2},
        {"name": "refusals", "kind": "refusals",
         "cases": [[3, None], [2, 2], [0, None]]},
    ]
    reports_four = launch({**base, "legs": legs_four}, four, n=4,
                          timeout=420)
    return {"data": d, "init": init, "two": two, "four": four,
            "r2": reports_two, "r4": reports_four}


# ---------------- the mesh ----------------

@pytest.mark.parametrize("tp", [1, 2, 4])
def test_mesh_2d_coordinates_match_jax(tp):
    """Rank r sits where JAX's make_mesh_2d puts device r: (r // tp,
    r % tp), the model axis innermost."""
    mesh = j_make_mesh_2d(tp)
    devices = jax.devices()
    for r in range(8):
        where = np.argwhere(mesh.devices == devices[r])[0]
        mine = Mesh(r, 8, CPU, "gloo", tp=tp)
        assert (mine.data_rank, mine.model_rank) == tuple(where)
        assert (mine.data_world, mine.tp) == (mesh.shape["data"],
                                              mesh.shape["model"])


def test_mesh_2d_refusals(monkeypatch):
    """JAX's refusals (more devices than visible, tp not dividing the
    count; tp.py:62-71) and the port's own: tp > 1 without a process
    group, tp below 1. tp = 1 is make_mesh's mesh, unchanged."""
    assert make_mesh_2d(1, None, "cpu") == make_mesh(None, "cpu") == \
        Mesh(0, 1, CPU)
    mesh = Mesh(0, 1, CPU)
    assert (mesh.data_rank, mesh.data_world, mesh.model_rank,
            mesh.data_group, mesh.model_group) == (0, 1, 0, None, None)
    with pytest.raises(ValueError, match="needs a process group"):
        make_mesh_2d(2, None, "cpu")
    with pytest.raises(ValueError, match="tp must be >= 1"):
        make_mesh_2d(0, None, "cpu")
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        j_make_mesh_2d(3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="only 1 CUDA device"):
        make_mesh_2d(2, 2, "cuda")
    with pytest.raises(ValueError, match="only 8 JAX device"):
        j_make_mesh_2d(2, num_devices=16)


def test_mesh_2d_refusals_inside_a_group(setup):
    """Inside a group of 4 ranks: tp = 3 does not divide it, a 2-rank
    mesh is not the group's, tp = 0 is refused."""
    for report in setup["r4"]:
        got = report["refusals"]
        assert got["3,None"] == "4 ranks not divisible by tp=3"
        assert "2-rank mesh inside a process group of 4" in got["2,2"]
        assert got["0,None"] == "tp must be >= 1, got 0"


# ---------------- the rules ----------------

# (name, JAX model widths, tp): test_tp.py's divisible widths, its odd
# widths (vocabulary 21, 9 answers), and n = 3 kernels whose n·d divides
# tp while n does not (conv1 72 = 3 x 24 rows, conv2 36 = 3 x 12)
SPEC_CASES = [
    ("divisible", dict(vocab_size=20, out_dim=8, hid_dim=32,
                       combined_dim=16, n_kernels=4), 2),
    ("divisible", dict(vocab_size=20, out_dim=8, hid_dim=32,
                       combined_dim=16, n_kernels=4), 4),
    ("odd", dict(vocab_size=21, out_dim=9, hid_dim=32, combined_dim=16,
                 n_kernels=4), 2),
    ("three_kernels", dict(vocab_size=20, out_dim=8, hid_dim=36,
                           combined_dim=18, n_kernels=3), 2),
    ("three_kernels", dict(vocab_size=20, out_dim=8, hid_dim=36,
                           combined_dim=18, n_kernels=3), 4),
]


def _jax_params(widths):
    """Random JAX parameters at ``widths`` (shapes from the model's init,
    values from a seed)."""
    cfg = JModelConfig(emb_dim=24, feat_dim=28, n_obj=N_OBJ,
                       neighbourhood_size=4, max_qlen=QLEN,
                       compute_dtype="float32", use_pallas=False, **widths)
    model = JModel(cfg=cfg)
    shapes = jax.eval_shape(
        model.init, jax.random.key(0), jax.ShapeDtypeStruct((2, QLEN),
                                                            np.int32),
        jax.ShapeDtypeStruct((2, N_OBJ, 28), np.float32),
        jax.ShapeDtypeStruct((2,), np.int32))
    rng = np.random.default_rng(7)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _port_names(path, n_kernels):
    """The port's parameter names that JAX's leaf at ``path`` becomes
    (models/weights.py::state_dict_from_jax_params), and whether the
    port's rows are the JAX leaf's columns."""
    *owner, name = path
    prefix = ".".join(owner[1:])            # without "params"
    gru = {"gru_w_ih": "weight_ih_l0", "gru_w_hh": "weight_hh_l0",
           "gru_b_ih": "bias_ih_l0", "gru_b_hh": "bias_hh_l0"}
    if name in gru:
        return [f"q_gru.{gru[name]}"], False
    if name == "wembed":
        return ["wembed.weight"], False
    if name == "conv_kernels":
        return [f"{prefix}.conv_weights.{i}.weight"
                for i in range(n_kernels)], True
    weight_norm = {"v": "weight_v", "g": "weight_g", "b": "bias"}
    if name in weight_norm:
        return [f"{prefix}.{weight_norm[name]}"], name == "v"
    return [f"{prefix}.{name}"], False



@pytest.mark.parametrize("case,widths,tp", SPEC_CASES,
                         ids=[f"{c}-tp{t}" for c, _, t in SPEC_CASES])
def test_param_spec_and_shards_match_jax(case, widths, tp):
    """For every JAX leaf: the port's spec on each name it becomes is
    JAX's spec (sharded or replicated), and the port's rows of model
    rank m, concatenated over a conv group's kernels, are JAX's shard
    on the devices of model column m (``shard_state``), transposed where
    JAX shards columns."""
    params = _jax_params(widths)
    mesh = j_make_mesh_2d(tp)
    placed = j_shard_state(params, mesh)
    sd = state_dict_from_jax_params(params)
    shapes = {k: tuple(v.shape) for k, v in sd.items()}
    ranges = [shard_rows(shapes, tp, m) for m in range(tp)]
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    placed_flat = [leaf for _, leaf in
                   jax.tree_util.tree_flatten_with_path(placed)[0]]
    seen = set()
    for (jpath, leaf), arr in zip(flat, placed_flat):
        path = tuple(str(k.key) for k in jpath)
        names, transposed = _port_names(path, widths["n_kernels"])
        spec = j_param_spec(jpath, leaf, mesh)
        sharded = any(a is not None for a in tuple(spec))
        n = len(names)
        for name in names:
            assert (param_spec(name, shapes[name], tp, n_kernels=n)
                    == (0 if sharded else None)), (case, name, spec)
            assert (name in ranges[0]) == sharded, name
            seen.add(name)
        for m in range(tp):
            dev = mesh.devices[0, m]
            (want,) = [np.asarray(s.data) for s in arr.addressable_shards
                       if s.device == dev]
            if transposed:
                want = want.T
            got = np.concatenate([
                sd[k].numpy()[slice(*ranges[m][k]) if sharded else slice(None)]
                for k in names])
            np.testing.assert_array_equal(got.reshape(want.shape), want,
                                          err_msg=f"{names} rank {m}")
    assert seen == set(sd)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_rows_split_each_conv_group_evenly(tp):
    """n = 3 kernels: the model ranks' rows of a conv group, in rank
    order, tile the concatenated rows once, each rank the same count,
    splitting a kernel where JAX's column range does."""
    sd = state_dict_from_jax_params(_jax_params(SPEC_CASES[3][1]))
    shapes = {k: tuple(v.shape) for k, v in sd.items()}
    for conv, d in (("graph_convolution_1", 24), ("graph_convolution_2",
                                                  12)):
        names = [f"{conv}.conv_weights.{i}.weight" for i in range(3)]
        covered = []
        for m in range(tp):
            rng = shard_rows(shapes, tp, m)
            mine = [(i * d + lo, i * d + hi)
                    for i, k in enumerate(names)
                    for lo, hi in [rng[k]] if hi > lo]
            assert sum(hi - lo for lo, hi in mine) == 3 * d // tp
            covered += mine
        rows = [r for lo, hi in covered for r in range(lo, hi)]
        assert rows == list(range(3 * d))
    # kernel 1 of conv1 is split between ranks 0 and 1 at tp = 2
    if tp == 2:
        assert shard_rows(shapes, 2, 0)[
            "graph_convolution_1.conv_weights.1.weight"] == (0, 12)
        assert shard_rows(shapes, 2, 1)[
            "graph_convolution_1.conv_weights.0.weight"] == (24, 24)


def test_weight_norm_rules_scoped_to_their_owners():
    """tests/test_tp.py::test_vgb_rules_scoped_to_weight_norm_owners on
    the port's names: weight_v / weight_g / bias shard only inside
    edge_layer_* and out_*."""
    for owner in ("mystery_module", "adjacency_1.layer", "outer"):
        for leaf, shape in (("weight_v", (8, 8)), ("weight_g", (8, 1)),
                            ("bias", (8,))):
            assert param_spec(f"{owner}.{leaf}", shape, 2) is None
    for owner in ("out_1", "adjacency_1.edge_layer_2", "edge_layer_9"):
        for leaf, shape in (("weight_v", (8, 8)), ("weight_g", (8, 1)),
                            ("bias", (8,))):
            assert param_spec(f"{owner}.{leaf}", shape, 2) == 0
    # an indivisible dim replicates; a conv kernel needs its group's size
    assert param_spec("out_2.weight_v", (3001, 3001), 2) is None
    assert param_spec("wembed.weight", (21, 300), 2) is None
    assert param_spec("g.conv_weights.0.weight", (12, 5), 2,
                      n_kernels=3) == 0
    with pytest.raises(ValueError, match="n_kernels"):
        param_spec("g.conv_weights.0.weight", (12, 5), 2)


def test_bf16_reduce_refused_on_a_model_axis():
    """JAX's supports_bf16_reduce refuses a model-parallel mesh
    (train/steps.py:419); so does the port's, whatever the cache."""
    tp_mesh = Mesh(0, 4, CPU, "gloo", tp=2)
    assert supports_bf16_reduce(None, tp_mesh) == \
        j_supports_bf16(j_make_mesh_2d(2), None) == \
        (False, "a model-parallel mesh")
    assert supports_bf16_reduce(None, Mesh(0, 4, CPU, "gloo")) == \
        (True, None)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp_small"))
    j_gen(d, **GEN)
    return d


def test_feature_cache_on_a_model_axis_matches_jax(small, capsys):
    """A table within the budget is replicated; over it, a (data, model)
    mesh streams from the host with JAX's message, never sharded."""
    pds = _pds(small, "train")
    mesh = Mesh(0, 4, CPU, "gloo", tp=2)
    got = make_feature_cache(pds, TrainConfig(), "float32", mesh=mesh)
    assert isinstance(got, tuple) and got[0].shape[0] == 16
    capsys.readouterr()
    assert make_feature_cache(pds, TrainConfig(device_cache_bytes=10_000),
                              "float32", mesh=mesh) is None
    mine = capsys.readouterr().out
    assert j_loop.make_feature_cache(
        _jds(small, "train"), j_make_mesh_2d(2, num_devices=4),
        JTrainConfig(device_cache_bytes=10_000, pallas_gather=False),
        "float32") is None
    theirs = capsys.readouterr().out
    assert mine == theirs and "mesh has a model axis" in mine


def test_train_step_refuses_a_plain_optimizer_on_a_model_axis(small):
    """A (data, model) mesh needs shard_optimizer's Adam: a tp = 1 one
    is refused before any collective, never stepped as if tp were 1."""
    pds = _pds(small, "train")
    model = build_model(ModelConfig(**MODEL), pds, device="cpu")
    optimizer, _ = make_optimizer(model, TrainConfig(), 1)
    batch = next(iter(Batcher(pds, 8, materialize=False)))
    with pytest.raises(ValueError, match="shard_optimizer"):
        train_step(model, optimizer, None, batch,
                   mesh=Mesh(0, 2, CPU, "gloo", tp=2),
                   n_valid=float(batch["mask"].sum()))


# ---------------- the launches ----------------

def _shas(reports, leg):
    return {r[leg]["sha"] for r in reports}


def _windows(records):
    keys = ("epoch", "step", "loss", "vqa_acc", "lr")
    return [[r[k] for k in keys] for r in records]


def test_dp1_tp2_equals_one_process_bit_for_bit(setup):
    """dp 1 x tp 2 from JAX's initial weights: both ranks end at the
    one-process path's weights bit for bit, with its logged windows."""
    r0, r1 = setup["r2"]
    assert (r0["world"], r1["rank"]) == (2, 1)
    assert _shas(setup["r2"], "tp2") == {r0["alone"]["sha"]}
    assert _windows(r0["tp2"]["records"]) == \
        _windows(r0["alone"]["records"])
    assert r0["tp2"]["acc"] == r1["tp2"]["acc"] == r0["alone"]["acc"]


@pytest.mark.parametrize("tp_leg,dp_leg", [
    ("dp2tp2", "dp2"), ("dp2tp2_dropout", "dp2_dropout"),
    ("dp2tp2_host", "dp2_host")])
def test_dp2_tp2_equals_dp2_bit_for_bit(setup, tp_leg, dp_leg):
    """dp 2 x tp 2 on four ranks and dp 2 on two: every rank's weights
    equal bit for bit, the logged windows and the mini-validations'
    accuracies equal (the replicated cache, dropout on, host mode)."""
    four, two = setup["r4"], setup["r2"]
    assert _shas(four, tp_leg) == _shas(two, dp_leg) and \
        len(_shas(two, dp_leg)) == 1
    assert _windows(four[0][tp_leg]["records"]) == \
        _windows(two[0][dp_leg]["records"])
    for r in four:
        assert r[tp_leg]["val_accs"] == two[0][dp_leg]["val_accs"]
        assert r[tp_leg]["acc"] == two[0][dp_leg]["acc"]


def test_dp2_tp2_matches_jax_tp_fit(setup, tmp_path):
    """JAX's fit(tp=2, num_devices=4) from the same initial checkpoint:
    every parameter of the port's dp 2 x tp 2 fit within JAX's own
    tolerance for its tp run (tests/test_tp.py)."""
    tcfg = JTrainConfig(**TRAIN, num_devices=4, tp=2,
                        save_dir=str(tmp_path))
    _, state, _ = j_loop.fit(tcfg, JModelConfig(**MODEL, use_pallas=False),
                             _jds(setup["data"], "train"),
                             resume_path=setup["init"])
    want = state_dict_from_jax_params(jax.device_get(state.params))
    got = torch.load(os.path.join(setup["four"], "dp2tp2.pt"),
                     weights_only=True)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=k)


def test_sums_run_over_the_data_group_only(setup):
    """dp 2 x tp 2: the logged windows, the mini-validations and the
    epoch accuracy count each row once (equal to dp 2's: a sum over all
    four ranks would double the loss and the validation accuracy), and
    the per-chip rate divides by the data extent, 2, as JAX's."""
    four, two = setup["r4"], setup["r2"]
    recs = four[0]["dp2tp2"]["records"]
    assert len(recs) == 3 and len(four[0]["dp2tp2"]["val_accs"]) == 2
    for rec, dp in zip(recs, two[0]["dp2"]["records"]):
        assert rec["loss"] == dp["loss"] and rec["vqa_acc"] == dp["vqa_acc"]
        assert rec["qa_pairs_per_sec_per_chip"] == pytest.approx(
            rec["steps_per_sec"] * BS / 2)
        assert 0.5 < rec["loss"] < 1.0


@pytest.mark.parametrize("tp_leg,dp_leg", [
    ("evaluate_tp", "evaluate_dp"), ("evaluate_tp_host", "evaluate_dp_host")])
def test_evaluate_over_the_data_axis(setup, tp_leg, dp_leg):
    """evaluate on the 2-D mesh (rows by data coordinates, sums and
    gathers over the data group) returns what the 1-D mesh's does, on
    every rank: the resident epoch, and host mode with adjacencies."""
    four = setup["r4"]
    for r in four:
        assert r[tp_leg] == four[0][dp_leg]
    assert len(four[0][tp_leg]["result"]) == 64
    with open(os.path.join(setup["four"], f"{tp_leg}_rank0.json")) as f:
        assert json.load(f) == four[0][dp_leg]["result"]
    assert not os.path.exists(os.path.join(setup["four"],
                                           f"{tp_leg}_rank2.json"))


def _ckpt(setup, run, leg, epoch=1):
    return torch.load(os.path.join(setup[run], leg, "rank0",
                                   f"model_{epoch}.ckpt"), weights_only=True)


def _assert_same_checkpoint(a, b):
    assert a.keys() == b.keys()
    for k in a["state_dict"]:
        assert torch.equal(a["state_dict"][k], b["state_dict"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys() and len(sa) == len(a["state_dict"])
    for i in sa:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][key], sb[i][key]), (i, key)
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
    assert a["scheduler"] == b["scheduler"]
    assert torch.equal(a["generator"], b["generator"])
    assert (a["step"], a["epoch"], a["extra"]) == \
        (b["step"], b["epoch"], b["extra"])


def test_checkpoints_keep_the_tp1_layout(setup):
    """A tp = 2 run's checkpoint (rank 0's, written after every rank
    gathered the moment shards) equals the tp = 1 run's at the same step:
    whole moments per parameter, one generator per data index."""
    tp1 = _ckpt(setup, "two", "alone_dropout")
    tp2 = _ckpt(setup, "two", "tp2_dropout")
    _assert_same_checkpoint(tp2, tp1)
    assert tp1["rank_generators"] is tp2["rank_generators"] is None
    dp2 = _ckpt(setup, "two", "dp2_dropout", epoch=2)
    dp2tp2 = _ckpt(setup, "four", "dp2tp2_dropout", epoch=2)
    _assert_same_checkpoint(dp2tp2, dp2)
    assert len(dp2tp2["rank_generators"]) == 2
    for a, b in zip(dp2tp2["rank_generators"], dp2["rank_generators"]):
        assert torch.equal(a, b)
    assert not torch.equal(*dp2tp2["rank_generators"])


def test_checkpoints_resume_across_tp_bit_for_bit(setup):
    """tp = 1 resumes a tp = 2 run's mid-epoch checkpoint, and tp = 2 a
    tp = 1 run's: each ends at the uninterrupted run's weights bit for
    bit, its remaining windows equal."""
    r0 = setup["r2"][0]
    whole = r0["alone_dropout"]
    assert r0["tp2_dropout"]["sha"] == whole["sha"]
    for leg in ("tp2_from_alone", "alone_from_tp2"):
        assert _shas(setup["r2"], leg) == {whole["sha"]}, leg
        resumed = _windows(r0[leg]["records"])
        assert len(resumed) == 4 and resumed == \
            _windows(whole["records"])[-4:]


def test_model_group_draws_the_same_dropout(setup):
    """Dropout on: the ranks of each model group draw their data index's
    stream, so their weights stay equal (and equal dp 2's, whose rank d
    draws index d's)."""
    four = setup["r4"]
    assert four[0]["dp2tp2_dropout"]["sha"] == \
        four[1]["dp2tp2_dropout"]["sha"]
    assert four[2]["dp2tp2_dropout"]["sha"] == \
        four[3]["dp2tp2_dropout"]["sha"]
    assert _shas(four, "dp2tp2_dropout") == _shas(setup["r2"], "dp2_dropout")


def test_only_rank0_writes_under_tp(setup):
    four = setup["r4"]
    for leg in ("dp2tp2", "dp2tp2_dropout"):
        assert "metrics.jsonl" in four[0][leg]["files"]
        for r in four[1:]:
            assert r[leg]["files"] == [] and r[leg]["records"] is None
            assert r[leg]["rank0_records"] == four[0][leg]["records"]
    assert {"model_1.ckpt", "model_2.ckpt"} <= set(
        four[0]["dp2tp2_dropout"]["files"])


# ---------------- the CLI ----------------

def test_cli_trains_over_four_ranks_at_tp2(tmp_path):
    """``--train --tp 2 --num_devices 4 --device cpu``: four spawned gloo
    ranks on a 2 x 2 grid write rank 0's checkpoints and metrics.jsonl;
    the checkpoint loads into a tp = 1 model and Adam with every
    parameter's whole moments."""
    from vqa_project_tpu_torch.train import load_checkpoint

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    argv = ["--synthetic", "--hid", "32", "--n_kernels", "4",
            "--neighbourhood_size", "4", "--bsize", "16", "--device", "cpu",
            "--compute_dtype", "float32", "--data_dir", "data"]
    p = subprocess.run(
        [sys.executable, "-m", "vqa_project_tpu_torch.cli.run", "--train",
         *argv, "--tp", "2", "--num_devices", "4", "--ep", "1",
         "--log_interval", "2", "--eval_interval", "0", "--save_dir",
         "save"], cwd=str(tmp_path), env=env, capture_output=True,
        text=True, timeout=420)
    assert p.returncode == 0, p.stdout + p.stderr
    assert sorted(os.listdir(tmp_path / "save")) == ["metrics.jsonl",
                                                     "model_1.ckpt"]
    with open(tmp_path / "save" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert len(recs) == 2 and all(np.isfinite(r["loss"]) for r in recs)
    ds = GraphVQADataset.vqa2(str(tmp_path / "data" / "synthetic"), "train")
    model = build_model(ModelConfig(hid_dim=32, n_kernels=4,
                                    neighbourhood_size=4,
                                    compute_dtype="float32"), ds,
                        device="cpu")
    optimizer, scheduler = make_optimizer(model, TrainConfig(), 4)
    payload = load_checkpoint(str(tmp_path / "save" / "model_1.ckpt"),
                              model, optimizer, scheduler)
    assert payload["train_config"]["tp"] == 2 and payload["step"] == 4
    for param in model.parameters():
        st = optimizer.state[param]
        assert st["exp_avg"].shape == st["exp_avg_sq"].shape == param.shape
        assert int(st["step"]) == 4
