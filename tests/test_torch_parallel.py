"""The data-parallel pieces of the port that need no second process, on
the CPU: the partitioned and rank-sharded Batcher against the JAX
package's, the batch split, the mesh and spawn refusals, the knobs' rule
against the JAX CLI's, the gradient all-reduce's dtype rule, the
metric logger's per-chip rate and serving over several devices.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_data import _datasets
from vqa_project_tpu.cli.run import input_args as j_input_args
from vqa_project_tpu.cli.run import resolve_dtype_knobs as j_resolve
from vqa_project_tpu.data.loader import Batcher as JBatcher
from vqa_project_tpu_torch.cli import medical, run, serve as serve_cli
from vqa_project_tpu_torch.config import ModelConfig
from vqa_project_tpu_torch.data import Batcher, generate_synthetic_vqa
from vqa_project_tpu_torch.parallel import (Mesh, all_reduce_grads,
                                            make_mesh, multihost,
                                            reduce_dtype, shard_batch)
from vqa_project_tpu_torch.serve import InferenceServer
from vqa_project_tpu_torch.train import MetricLogger, build_model
from vqa_project_tpu_torch.train.loop import dropout_seed

CPU = torch.device("cpu")
HOST_FIELDS = ("question", "qlen", "qid", "mask", "index", "answers",
               "votes", "image")


def _partitions(pds, n):
    return (pds.table.image_row % n).astype(np.int32)


@pytest.mark.parametrize("shuffle,materialize,n", [
    (True, False, 2), (False, False, 2), (True, True, 3), (True, False, 5)])
def test_partitioned_batcher_matches_jax(rng, shuffle, materialize, n):
    """Locality batches: each rank's pool shuffled per epoch, B / n taken
    from each, short pools padded with their head under mask 0; len the
    longest pool's; a resumed epoch skips alike."""
    jds, pds = _datasets(rng)
    parts = _partitions(pds, n)
    bs = 2 * n
    kw = dict(shuffle=shuffle, seed=7, drop_last=True,
              materialize=materialize, partitions=parts, n_partitions=n)
    jb, pb = JBatcher(jds, bs, **kw), Batcher(pds, bs, **kw)
    assert len(pb) == len(jb)
    for _ in range(2):                      # two epochs: the order moves
        got, want = list(pb), list(jb)
        assert len(got) == len(want) == len(pb)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    jb.set_epoch(3, skip=1)
    pb.set_epoch(3, skip=1)
    got, want = list(pb), list(jb)
    assert len(got) == len(want) == len(pb) - 1
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_partitioned_batcher_refuses_an_indivisible_batch(rng):
    _, pds = _datasets(rng)
    with pytest.raises(ValueError, match="not divisible by 3 cache shards"):
        Batcher(pds, 4, partitions=_partitions(pds, 3), n_partitions=3)


@pytest.mark.parametrize("rank", [0, 1])
def test_host_mode_rank_makes_its_dense_rows_only(rng, rank):
    """Batcher(shard=(r, 2)): the global order and light fields, the
    dense image/answers/votes of rank r's half only; shard_batch then
    gives the rank's batch, equal to the slice of the whole one."""
    _, pds = _datasets(rng)
    whole = list(Batcher(pds, 6, shuffle=True, seed=5))
    mine = list(Batcher(pds, 6, shuffle=True, seed=5, shard=(rank, 2)))
    rows = slice(3 * rank, 3 * rank + 3)
    mesh = Mesh(rank, 2, CPU)
    for w, m in zip(whole, mine):
        for k in ("image", "answers", "votes"):
            np.testing.assert_array_equal(m[k], w[k][rows], err_msg=k)
        for k in ("question", "qid", "mask", "index"):
            np.testing.assert_array_equal(m[k], w[k], err_msg=k)
        local = shard_batch(m, mesh)
        for k in HOST_FIELDS:
            np.testing.assert_array_equal(local[k], w[k][rows], err_msg=k)


def test_shard_batch_and_local_rows(rng):
    _, pds = _datasets(rng)
    batch = next(iter(Batcher(pds, 8, materialize=False)))
    assert shard_batch(batch, Mesh(0, 1, CPU)) is batch
    for r in range(4):
        rows = multihost.local_batch_rows(8, r, 4)
        assert rows == slice(2 * r, 2 * r + 2)
        local = shard_batch(batch, Mesh(r, 4, CPU))
        for k, v in batch.items():
            np.testing.assert_array_equal(local[k], v[rows], err_msg=k)
    with pytest.raises(ValueError, match="not divisible by 3"):
        multihost.local_batch_rows(8, 0, 3)


def test_without_a_group_the_process_is_rank_0_of_1():
    assert (multihost.rank(), multihost.world()) == (0, 1)
    assert multihost.is_primary() and not multihost.is_multiprocess()
    multihost.barrier()                                   # no-op
    x = torch.arange(6, dtype=torch.int32).view(2, 3)
    np.testing.assert_array_equal(multihost.fetch_global(x), x.numpy())
    assert multihost.all_reduce_sum(x) is x
    assert multihost.primary_first(lambda: 7) == 7
    assert make_mesh(None, "cpu") == Mesh(0, 1, CPU, None)
    assert not multihost.maybe_initialize_distributed("cpu")


def test_mesh_refusals(monkeypatch):
    with pytest.raises(ValueError, match="needs a process group"):
        make_mesh(2, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="only 1 CUDA device"):
        make_mesh(2, "cuda")


def test_ranks_to_spawn(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.ranks_to_spawn(None, "cpu") == 0
    assert multihost.ranks_to_spawn(1, "cpu") == 0
    assert multihost.ranks_to_spawn(3, "cpu") == 3
    # no card here: every visible card is none, two is too many
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert multihost.ranks_to_spawn(None, "cuda") == 0
    with pytest.raises(ValueError, match="only 0 CUDA"):
        multihost.ranks_to_spawn(2, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert multihost.ranks_to_spawn(None, "cuda") == 4
    assert multihost.ranks_to_spawn(2, "cuda") == 2
    # under torchrun this process is a rank already
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert multihost.ranks_to_spawn(4, "cuda") == 0


def test_num_devices_beyond_the_visible_cards_raises(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="only 0 CUDA"):
        run.main(["--train", "--synthetic", "--num_devices", "2"])
    with pytest.raises(ValueError, match="only 0 CUDA"):
        medical.grid_search_main(*medical.medical_input_args(
            ["--num_devices", "3"]), dataset_name="imageclef",
            ckpt_prefix="clef")
    args = serve_cli.input_args(["--num_devices", "2"])
    with pytest.raises(ValueError, match="only 0 CUDA"):
        serve_cli.serving_devices(args)


@pytest.mark.parametrize("argv,tp", [
    ([], 1), (["--tp", "2"], 2), (["--tp", "4", "--num_devices", "8"], 4)],
    ids=lambda a: " ".join(a) if isinstance(a, list) else str(a))
def test_tp_flag_parses_as_the_jax_cli(argv, tp):
    """--tp: JAX's name and default (1), into TrainConfig.tp."""
    args, _, unparsed = run.input_args(argv)
    assert not unparsed and args.tp == j_input_args(argv)[0].tp == tp
    assert run.make_configs(args)[1].tp == tp


@pytest.mark.parametrize("argv", [
    ["--fast_math", "--tp", "2"], ["--fast_math", "--tp", "1"],
    ["--fast_math", "--tp", "2", "--grad_reduce_dtype", "bfloat16"],
    ["--tp", "2"]], ids=lambda a: " ".join(a))
def test_fast_math_reduces_in_bf16_only_at_tp_1(argv):
    """--fast_math's bf16 gradient reduce needs the 1-D data mesh: at
    --tp 2 it resolves to float32 (an explicit flag still wins), as in
    JAX's CLI (cli/run.py:172); the Adam moments stay bf16."""
    args, _, _ = run.input_args(argv)
    j_args = j_input_args(argv)[0]
    assert run.resolve_grad_reduce(args) == j_resolve(j_args)[2]
    assert run.resolve_dtype_knobs(args) == j_resolve(j_args)[:2]


@pytest.mark.parametrize("argv,message", [
    (["--tp", "2", "--num_devices", "3"], "3 not divisible by --tp 2"),
    (["--tp", "4", "--num_devices", "2"], "2 not divisible by --tp 4"),
    (["--tp", "0"], "--tp must be >= 1")])
def test_num_devices_must_divide_by_tp(monkeypatch, argv, message):
    """Refused before any rank starts."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match=message):
        run.main(["--train", "--synthetic", "--device", "cpu", *argv])


@pytest.mark.parametrize("argv", [
    [], ["--fast_math"], ["--fast_math", "--grad_reduce_dtype", "float32"],
    ["--grad_reduce_dtype", "bfloat16"], ["--num_devices", "4"]],
    ids=lambda a: " ".join(a) or "none")
def test_grad_reduce_and_num_devices_resolve_as_the_jax_cli(argv):
    args, _, unparsed = run.input_args(argv)
    assert not unparsed
    j_args = j_input_args(argv)[0]
    assert run.resolve_grad_reduce(args) == j_resolve(j_args)[2]
    _, tcfg = run.make_configs(args)
    assert tcfg.grad_reduce_dtype == j_resolve(j_args)[2]
    assert tcfg.num_devices == j_args.num_devices


def test_serving_devices_flag():
    one = serve_cli.input_args(["--device", "cpu"])
    assert one.num_devices == 1 and serve_cli.serving_devices(one) == ["cpu"]
    two = serve_cli.input_args(["--device", "cpu", "--num_devices", "2"])
    assert serve_cli.serving_devices(two) == ["cpu", "cpu"]


def test_dropout_streams_per_rank():
    assert dropout_seed(1000, 0) == 1000
    seeds = {dropout_seed(1000, r) for r in range(8)}
    assert len(seeds) == 8
    assert dropout_seed(1000, 3) == dropout_seed(1000, 3)
    assert dropout_seed(1001, 3) != dropout_seed(1000, 3)


def test_reduce_dtype_rule():
    """No collective without a group; bf16 only across ranks (JAX's
    world > 1 rule); nothing else accepted."""
    alone = Mesh(0, 1, CPU, None)
    assert reduce_dtype(alone, "bfloat16") is None
    assert reduce_dtype(Mesh(0, 1, CPU, "gloo"), "bfloat16") == "float32"
    assert reduce_dtype(Mesh(0, 2, CPU, "gloo"), "bfloat16") == "bfloat16"
    assert reduce_dtype(Mesh(0, 2, CPU, "gloo"), "float32") == "float32"
    with pytest.raises(ValueError, match="float32|bfloat16"):
        reduce_dtype(Mesh(0, 2, CPU, "gloo"), "float16")
    model = torch.nn.Linear(3, 2)
    model(torch.ones(1, 3)).sum().backward()
    before = [p.grad.clone() for p in model.parameters()]
    all_reduce_grads(model, alone, "bfloat16")
    for p, g in zip(model.parameters(), before):
        assert torch.equal(p.grad, g)


def test_metric_logger_reports_per_chip(tmp_path, capsys):
    path = tmp_path / "m.jsonl"
    logger = MetricLogger(1, str(path), n_chips=4, batch_size=64)
    logger.log_window(epoch=0, step=1, loss_sum=2.0, score_sum=8.0, n=1,
                      examples=64.0)
    logger.close()
    import json

    rec = json.loads(path.read_text())
    assert rec["qa_pairs_per_sec_per_chip"] == pytest.approx(
        rec["steps_per_sec"] * 64 / 4)
    assert rec["loss"] == 2.0 and rec["vqa_acc"] == 12.5


@pytest.fixture(scope="module")
def served():
    ds = generate_synthetic_vqa(n_images=8, n_questions=48, n_obj=10,
                                feat_dim=28, emb_dim=16, max_qlen=8)["val"]
    model = build_model(ModelConfig(hid_dim=32, combined_dim=16,
                                    n_kernels=4, neighbourhood_size=4,
                                    compute_dtype="float32"), ds,
                        device="cpu")
    return ds, model


def test_serving_over_two_devices_equals_one(served):
    """InferenceServer(devices=[cpu, cpu]) splits each padded batch in
    two; its top-1 answers (and top-k) equal one device's on every
    request."""
    ds, model = served
    one = InferenceServer(model, ds, device="cpu", batch_size=8)
    two = InferenceServer(model, ds, devices=["cpu", "cpu"], batch_size=8)
    try:
        assert two.devices == [CPU, CPU] and len(two._replicas) == 2
        assert two._replicas[0] is two._replicas[1]
        words = list(ds.q_wtoi)
        ids = list(ds.store.id_to_row)
        rng = np.random.default_rng(3)
        for i in range(12):
            q = " ".join(rng.choice(words, size=4))
            iid = ids[i % len(ids)]
            a = one.predict(q, image_id=iid)
            b = two.predict(q, image_id=iid)
            assert a["answer"] == b["answer"]
            assert [t["answer"] for t in a["top_k"]] == \
                [t["answer"] for t in b["top_k"]]
        # a full padded batch straight through the split forward
        batch = one.pad_batch([])
        va, ia = one._forward(*batch)
        vb, ib = two._forward(*batch)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_allclose(va, vb, rtol=1e-6, atol=1e-7)
    finally:
        one.close()
        two.close()


def test_serving_refuses_an_indivisible_batch(served):
    ds, model = served
    with pytest.raises(ValueError, match="not divisible by 3 serving"):
        InferenceServer(model, ds, devices=["cpu"] * 3, batch_size=8)
