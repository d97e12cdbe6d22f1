"""Data-parallel training and evaluation of the port over two real
processes (gloo, on the CPU), against the JAX package on its 2-device
CPU mesh and against the port in one process.

Two ranks run ``fit`` and ``evaluate`` on the JAX generator's synthetic
files (tests/_torch_dp_child.py): the replicated cache, the sharded
cache (forced by a budget between half the table and the whole), host
mode, the bf16 gradient reduce, a mid-epoch resume with dropout on, and
one step on a locality batch whose halves hold unequal valid counts. In
f32 with dropout 0 the port's window losses equal JAX's 2-device fit's
within 1e-5, both starting from JAX's initial weights (a JAX checkpoint
at epoch 0 that both resume from). Then the CLIs over two spawned ranks.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests._torch_dp_child import ROOT, launch, params_sha
from vqa_project_tpu.config import ModelConfig as JModelConfig
from vqa_project_tpu.config import TrainConfig as JTrainConfig
from vqa_project_tpu.data import GraphVQADataset as JDataset
from vqa_project_tpu.data.synthetic import generate_synthetic_vqa as j_gen
from vqa_project_tpu.models.torch_import import import_torch_state_dict
from vqa_project_tpu.train import loop as j_loop
from vqa_project_tpu.train.state import create_train_state
from vqa_project_tpu.train.state import make_optimizer as j_make_optimizer
from vqa_project_tpu.train.state import save_checkpoint as j_save
from vqa_project_tpu_torch.config import ModelConfig, TrainConfig
from vqa_project_tpu_torch.data import GraphVQADataset
from vqa_project_tpu_torch.train import build_model, evaluate, fit
from vqa_project_tpu_torch.train import make_optimizer
from vqa_project_tpu_torch.train.steps import train_step

N_OBJ, QLEN, BS, EPOCH_STEPS = 8, 10, 32, 6
GEN = dict(n_images=16, n_questions=256, n_obj=N_OBJ, feat_dim=24,
           q_vocab=20, n_answers=8)
MODEL = dict(hid_dim=32, combined_dim=16, n_kernels=4, neighbourhood_size=4,
             dropout=0.0, compute_dtype="float32")
# the f32 table (16 x 8 x 24) and its boxes: 14,336 bytes; a budget
# between half and the whole shards it over two ranks
TABLE_BYTES = 16 * 8 * 24 * 4 + 16 * 8 * 4 * 4
SHARD_BUDGET = 10_000
TRAIN = dict(lr=1e-3, epochs=1, batch_size=BS, log_interval=2,
             eval_interval=0, seed=1000)
CACHES = {"replicated": {}, "sharded": {"device_cache_bytes": SHARD_BUDGET},
          "host": {"device_cache_bytes": 0}}


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


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The synthetic files, JAX's initial state as a checkpoint at epoch
    0, and the reports of one two-rank launch of every leg."""
    root = tmp_path_factory.mktemp("dp")
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
    fits = [{"name": name, "kind": "fit", "model": MODEL, "resume": init,
             "train": {**TRAIN, **extra}} for name, extra in CACHES.items()]
    fits += [{"name": f"bf16_{name}", "kind": "fit", "model": MODEL,
              "resume": init, "train": {**TRAIN, **CACHES[name],
                                        "grad_reduce_dtype": "bfloat16"}}
             for name in ("replicated", "sharded")]
    # dropout on, checkpoints at step 4 of each epoch (6 steps an epoch)
    drop = {"model": {**MODEL, "dropout": 0.5}, "with_val": True,
            "train": {**TRAIN, "epochs": 2, "eval_interval": 4}}
    legs = fits + [
        {"name": "evaluate", "kind": "evaluate", "model": MODEL,
         "weights": "replicated", "batch_size": BS},
        {"name": "evaluate_sharded", "kind": "evaluate", "model": MODEL,
         "weights": "replicated", "batch_size": BS,
         "train": {"device_cache_bytes": SHARD_BUDGET}},
        {"name": "evaluate_host", "kind": "evaluate", "model": MODEL,
         "weights": "replicated", "batch_size": BS, "adjacency": True,
         "train": {"device_cache_bytes": 0}},
        {"name": "dropout", "kind": "fit", **drop},
        {"name": "resumed", "kind": "fit", **drop,
         "resume": str(root / "out" / "dropout" / "rank0" / "model_1.ckpt")},
        {"name": "step", "kind": "step", "model": MODEL, "lr": 1e-2,
         "batch_size": 16, "rank1_questions": 2},
    ]
    spec = {"data_dir": d, "n_obj": N_OBJ, "max_qlen": QLEN, "legs": legs}
    reports = launch(spec, str(root / "out"), n=2, timeout=420)
    return {"data": d, "init": init, "out": str(root / "out"),
            "reports": reports, "jstate": state}


def _losses(records):
    return np.array([r["loss"] for r in records])


def _jax_fit(setup, tmp_path, **extra):
    tcfg = JTrainConfig(**{**TRAIN, **extra}, num_devices=2,
                        save_dir=str(tmp_path))
    jsonl = str(tmp_path / "metrics.jsonl")
    j_loop.fit(tcfg, JModelConfig(**MODEL, use_pallas=False),
               _jds(setup["data"], "train"), resume_path=setup["init"],
               jsonl_path=jsonl)
    with open(jsonl) as f:
        return _losses([json.loads(line) for line in f])


def test_ranks_agree_bit_for_bit(setup):
    r0, r1 = setup["reports"]
    assert (r0["rank"], r1["rank"], r0["world"]) == (0, 1, 2)
    for leg in ("replicated", "sharded", "host", "bf16_replicated",
                "bf16_sharded", "dropout", "resumed", "step"):
        assert r0[leg]["sha"] == r1[leg]["sha"], leg
    for leg in ("replicated", "sharded", "host", "dropout"):
        assert r0[leg]["acc"] == r1[leg]["acc"], leg
    # weights are drawn from a CPU generator seeded alike on every rank
    assert r0["step"]["init_sha"] == r1["step"]["init_sha"]
    for leg in ("evaluate", "evaluate_sharded", "evaluate_host"):
        assert r0[leg] == r1[leg], leg


@pytest.mark.parametrize("cache", sorted(CACHES))
def test_fit_matches_jax_on_two_devices(setup, tmp_path, cache):
    """The two ranks' logged window losses equal JAX's 2-device fit's
    within 1e-5 (f32, dropout 0, the same initial weights and batches:
    locality batches for the sharded cache)."""
    got = _losses(setup["reports"][0][cache]["records"])
    want = _jax_fit(setup, tmp_path, **CACHES[cache])
    # locality batches run as many steps as the longest pool needs
    assert len(got) == len(want) == (4 if cache == "sharded" else 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_fit_matches_one_process(setup, tmp_path):
    """Two ranks and one process step on the same global batches: the
    same window losses within 1e-5 and the same weights within float
    rounding (the gradient is summed over the ranks, not in one
    backward)."""
    tcfg = TrainConfig(**TRAIN, save_dir=str(tmp_path))
    jsonl = str(tmp_path / "metrics.jsonl")
    model, _, _ = fit(tcfg, ModelConfig(**MODEL), _pds(setup["data"],
                                                       "train"),
                      device="cpu", resume_path=setup["init"],
                      jsonl_path=jsonl)
    with open(jsonl) as f:
        want = _losses([json.loads(line) for line in f])
    got = _losses(setup["reports"][0]["replicated"]["records"])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    two = torch.load(os.path.join(setup["out"], "replicated.pt"),
                     weights_only=True)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(two[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_bf16_reduce_close_to_f32_reduce(setup):
    """The bf16 all-reduce rounds each rank's contribution: its losses
    stay within 2e-3 of the f32 reduce's, its weights within JAX's
    tolerance for the same comparison (test_grad_reduce.py)."""
    r0 = setup["reports"][0]
    np.testing.assert_allclose(
        _losses(r0["bf16_replicated"]["records"]),
        _losses(r0["replicated"]["records"]), rtol=2e-3, atol=0)
    assert r0["bf16_replicated"]["sha"] != r0["replicated"]["sha"]
    a = torch.load(os.path.join(setup["out"], "replicated.pt"),
                   weights_only=True)
    b = torch.load(os.path.join(setup["out"], "bf16_replicated.pt"),
                   weights_only=True)
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), rtol=5e-2,
                                   atol=5e-4, err_msg=k)


def test_bf16_reduce_degrades_to_f32_with_a_sharded_cache(setup):
    r0 = setup["reports"][0]
    assert r0["bf16_sharded"]["sha"] == r0["sharded"]["sha"]
    assert r0["bf16_sharded"]["records"] is not None
    assert ([r["loss"] for r in r0["bf16_sharded"]["records"]]
            == [r["loss"] for r in r0["sharded"]["records"]])


def _jax_evaluate(setup, tmp_path, **tcfg):
    jds = _jds(setup["data"], "val")
    jmodel = j_loop.build_model(JModelConfig(**MODEL, use_pallas=False), jds)
    sd = torch.load(os.path.join(setup["out"], "replicated.pt"),
                    weights_only=True)
    path = str(tmp_path / "jax_result.json")
    acc, _, _ = j_loop.evaluate(
        jmodel, import_torch_state_dict(sd), jds, BS, result_path=path,
        num_devices=2, train_cfg=JTrainConfig(batch_size=BS, **tcfg))
    with open(path) as f:
        return acc, json.load(f)


@pytest.mark.parametrize("leg,tcfg", [
    ("evaluate", {}), ("evaluate_sharded",
                       {"device_cache_bytes": SHARD_BUDGET})])
def test_evaluate_matches_jax_on_two_devices(setup, tmp_path, leg, tcfg):
    """The two ranks' result.json (rank 0's file) and accuracy equal JAX's
    2-device evaluate of the same weights: the resident epoch with the
    replicated cache, and locality batches with the sharded one."""
    acc, want = _jax_evaluate(setup, tmp_path, **tcfg)
    with open(os.path.join(setup["out"], f"{leg}_rank0.json")) as f:
        got = json.load(f)
    assert got == want and len(got) == 64
    assert setup["reports"][0][leg]["acc"] == pytest.approx(acc, abs=1e-9)
    assert not os.path.exists(os.path.join(setup["out"], f"{leg}_rank1.json"))


def test_evaluate_host_mode_with_adjacency_matches_one_process(setup):
    ds = _pds(setup["data"], "val")
    model = build_model(ModelConfig(**MODEL), ds, device="cpu")
    model.load_state_dict(torch.load(
        os.path.join(setup["out"], "replicated.pt"), weights_only=True))
    acc, result, adj = evaluate(model, ds, BS, result_path=None,
                                collect_adjacency=True, cache=None,
                                device="cpu")
    got = setup["reports"][0]["evaluate_host"]
    assert got["result"] == result
    assert got["acc"] == pytest.approx(acc, abs=1e-9)
    assert sorted(got["adjacency"]) == sorted(str(k) for k in adj)
    for k, v in adj.items():
        np.testing.assert_allclose(np.asarray(got["adjacency"][str(k)]), v,
                                   rtol=1e-5, atol=1e-6)


def test_only_rank0_writes(setup):
    r0, r1 = setup["reports"]
    for leg in ("replicated", "dropout", "resumed"):
        assert "metrics.jsonl" in r0[leg]["files"], leg
        assert r1[leg]["files"] == [], leg
        assert r1[leg]["records"] is None
    assert {"model_1.ckpt", "model_2.ckpt"} <= set(r0["dropout"]["files"])
    assert os.path.exists(os.path.join(setup["out"], "evaluate_rank0.json"))
    assert not os.path.exists(os.path.join(setup["out"],
                                           "evaluate_rank1.json"))


def test_checkpoint_holds_every_rank_generator(setup):
    payload = torch.load(os.path.join(setup["out"], "dropout", "rank0",
                                      "model_1.ckpt"), weights_only=True)
    states = payload["rank_generators"]
    assert len(states) == 2
    assert torch.equal(states[0], payload["generator"])
    # rank 1 draws its own dropout stream
    assert not torch.equal(states[0], states[1])
    assert payload["extra"]["step_in_epoch"] == 4


def test_mid_epoch_resume_with_dropout_is_bit_exact(setup):
    """Both ranks restart from rank 0's checkpoint written at step 4 of
    epoch 1 (a file rank 1 never wrote) and end at the uninterrupted
    run's weights bit for bit, its windows of the rest of the run equal."""
    r0, r1 = setup["reports"]
    assert r0["resumed"]["sha"] == r1["resumed"]["sha"] == \
        r0["dropout"]["sha"]
    keys = ("epoch", "step", "loss", "vqa_acc", "lr")
    whole = [[r[k] for k in keys] for r in r0["dropout"]["records"]]
    resumed = [[r[k] for k in keys] for r in r0["resumed"]["records"]]
    assert len(resumed) == 4 and resumed == whole[-4:]


def test_loss_is_the_global_masked_mean(setup):
    """A partitioned batch whose rank-1 pool holds 2 questions: rank 0's
    half is full, rank 1's holds 2 valid rows of 8 (the rest padding
    under mask 0). The two-rank step equals one process stepping on the
    whole global batch (the global masked mean); DDP's average of the
    ranks' means is another loss."""
    r0, r1 = setup["reports"]
    mask = np.load(os.path.join(setup["out"], "step_mask.npy"))
    assert mask[:8].sum() == 8 and mask[8:].sum() == 2
    assert (r0["step"]["valid"], r1["step"]["valid"]) == (8.0, 2.0)
    ds = _pds(setup["data"], "train")
    model = build_model(ModelConfig(**MODEL), ds, device="cpu")
    optimizer, _ = make_optimizer(model, TrainConfig(lr=1e-2), 1)
    from tests._torch_dp_child import step_partitions
    from vqa_project_tpu_torch.data import Batcher

    batch = next(iter(Batcher(
        ds, 16, shuffle=False, n_partitions=2,
        partitions=step_partitions(ds, {"rank1_questions": 2}))))
    np.testing.assert_array_equal(batch["mask"], mask)
    m = train_step(model, optimizer, None, batch)
    loss = r0["step"]["loss"] + r1["step"]["loss"]
    assert loss == pytest.approx(float(m["loss"]), rel=1e-6)
    ddp = (r0["step"]["loss"] * 10 / 8 + r1["step"]["loss"] * 10 / 2) / 2
    assert abs(ddp - float(m["loss"])) > 1e-3
    two = torch.load(os.path.join(setup["out"], "step.pt"),
                     weights_only=True)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(two[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def _cli(args, cwd, timeout=420):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert p.returncode == 0, p.stdout + p.stderr
    return p.stdout


SMALL = ["--synthetic", "--hid", "32", "--n_kernels", "4",
         "--neighbourhood_size", "4", "--bsize", "16", "--device", "cpu",
         "--compute_dtype", "float32", "--data_dir", "data"]


def test_cli_over_two_spawned_ranks(tmp_path):
    """--num_devices 2 on the CPU: rank 0 generates the synthetic set
    behind the barrier, the ranks train together (--train: per-epoch
    checkpoints and metrics.jsonl from rank 0, mid-epoch validation
    summed over the ranks), and --eval writes the result.json that one
    process writes for the same checkpoint."""
    out = _cli(["vqa_project_tpu_torch.cli.run", "--train", *SMALL,
                "--num_devices", "2", "--ep", "2", "--log_interval", "2",
                "--eval_interval", "3", "--save_dir", "save"],
               str(tmp_path))
    with open(tmp_path / "data" / "synthetic" / "fingerprint.json") as f:
        assert json.load(f)["n_questions"] == 96
    saved = sorted(os.listdir(tmp_path / "save"))
    assert saved == ["metrics.jsonl", "model_1.ckpt", "model_2.ckpt"]
    with open(tmp_path / "save" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    # 72 train questions, batch 16: 4 steps an epoch, windows of 2, each
    # written once
    assert len(recs) == 4 and all(np.isfinite(r["loss"]) for r in recs)
    assert out.count("Validation accuracy") == 2 * 2   # both ranks print
    ckpt = str(tmp_path / "save" / "model_2.ckpt")
    results = {}
    for ranks in ("2", "1"):
        work = tmp_path / f"eval{ranks}"
        work.mkdir()
        os.symlink(tmp_path / "data", work / "data")
        _cli(["vqa_project_tpu_torch.cli.run", "--eval", *SMALL,
              "--num_devices", ranks, "--model_path", ckpt], str(work))
        with open(work / "result.json") as f:
            results[ranks] = json.load(f)
    assert results["2"] == results["1"] and len(results["1"]) == 24


def test_medical_grid_over_two_spawned_ranks(tmp_path):
    """run_imageclef --num_devices 2: one process group for the grid;
    rank 0 writes the grid file (one line per cell, not one per rank),
    the cells' checkpoints and the best cell's CSV."""
    _cli(["vqa_project_tpu_torch.cli.run_imageclef", "--synthetic",
          "--data_dir", "m", "--hid", "24", "--emb", "16", "--n_obj", "9",
          "--compute_dtype", "float32", "--ep", "1", "--bsize", "8",
          "--neighbors_list", "4", "3", "--kernels_list", "3",
          "--device", "cpu", "--num_devices", "2"], str(tmp_path))
    with open(tmp_path / "grid_search_nodes_9.txt") as f:
        lines = f.read().splitlines()
    assert [ln.split(", Validation")[0] for ln in lines] == [
        "neighbors: 4, kernels: 3", "neighbors: 3, kernels: 3"]
    ckpts = sorted(os.listdir(tmp_path / "save"))
    assert len(ckpts) == 2 and all(c.startswith("clef_9_3_") for c in ckpts)
    assert len(os.listdir(tmp_path / "figures")) >= 1


def test_weights_equal_across_processes_by_construction(setup):
    """The step leg's ranks built their models independently; their
    initial hashes equal this process's build of the same model."""
    ds = _pds(setup["data"], "train")
    model = build_model(ModelConfig(**MODEL), ds, device="cpu")
    assert params_sha(model) == setup["reports"][0]["step"]["init_sha"]


def test_jax_state_is_the_shared_start(setup):
    """Both sides start from the same weights: the port's resumed model
    equals JAX's initial parameters."""
    from vqa_project_tpu_torch.models import state_dict_from_jax_params
    from vqa_project_tpu_torch.train.loop import _resume_checkpoint

    ds = _pds(setup["data"], "train")
    model = build_model(ModelConfig(**MODEL), ds, device="cpu")
    opt, sched = make_optimizer(model, TrainConfig(**TRAIN), EPOCH_STEPS)
    assert _resume_checkpoint(setup["init"], model, opt, sched, None) == \
        (0, 0, 0)
    want = state_dict_from_jax_params(
        jax.device_get(setup["jstate"].params))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
