"""The port's sharded feature cache against the JAX package's, on the CPU.

Each rank's shard is built on its own (a mesh record of rank r of n; no
process group is needed for the upload or the gather) and held against
JAX's ``ShardedFeatureCache`` on its n-device CPU mesh: the partitions,
the rows each rank holds, and the per-rank gather of a locality batch,
the clamped rows of its padding included, bit for bit. Then the cache
mode selection by the per-card budget and the bf16 reduce's refusal.
"""

import jax
import numpy as np
import pytest
import torch

from vqa_project_tpu.config import TrainConfig as JTrainConfig
from vqa_project_tpu.data import Batcher as JBatcher
from vqa_project_tpu.data import GraphVQADataset as JDataset
from vqa_project_tpu.data.synthetic import generate_synthetic_vqa as j_gen
from vqa_project_tpu.parallel import make_mesh as j_make_mesh
from vqa_project_tpu.parallel import shard_batch as j_shard_batch
from vqa_project_tpu.parallel.sharded_cache import \
    ShardedFeatureCache as JShardedCache
from vqa_project_tpu.train import loop as j_loop
from vqa_project_tpu.train.steps import \
    supports_bf16_reduce as j_supports_bf16
from vqa_project_tpu_torch.config import ModelConfig, TrainConfig
from vqa_project_tpu_torch.data import Batcher, GraphVQADataset
from vqa_project_tpu_torch.parallel import Mesh, ShardedFeatureCache
from vqa_project_tpu_torch.train import build_model, make_optimizer
from vqa_project_tpu_torch.train.loop import make_feature_cache
from vqa_project_tpu_torch.train.steps import (QuantizedFeatureCache,
                                               make_image_fn,
                                               supports_bf16_reduce,
                                               train_step)

N_OBJ, FEAT, QLEN = 8, 24, 10
# the f32 table and its boxes
TABLE = 20 * N_OBJ * FEAT * 4 + 20 * N_OBJ * 4 * 4


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth_shard_torch")
    j_gen(str(d), n_images=20, n_questions=160, n_obj=N_OBJ, feat_dim=FEAT,
          q_vocab=16, n_answers=8)
    return str(d)


def _ds(data_dir):
    return (JDataset.vqa2(data_dir, "train", n_obj=N_OBJ, max_qlen=QLEN),
            GraphVQADataset.vqa2(data_dir, "train", 300, N_OBJ, QLEN))


def _shards(store, n):
    return [ShardedFeatureCache.build(store, Mesh(r, n, torch.device("cpu")))
            for r in range(n)]


@pytest.mark.parametrize("n", [2, 8])
def test_partitions_and_shards_match_jax(data_dir, n):
    jds, pds = _ds(data_dir)
    jcache = JShardedCache.build(jds.store, j_make_mesh(n))
    shards = _shards(pds.store, n)
    for c in shards:
        assert c.shard_size == jcache.shard_size and c.n_images == 20
        np.testing.assert_array_equal(c.partitions(), jcache.partitions())
    # rank r holds the table's rows [r S, (r + 1) S), zero past the end
    feats = np.concatenate([c.features.numpy() for c in shards])
    boxes = np.concatenate([c.boxes.numpy() for c in shards])
    np.testing.assert_array_equal(feats, np.asarray(jcache.features))
    np.testing.assert_array_equal(boxes, np.asarray(jcache.boxes))
    assert not feats[20:].any()


@pytest.mark.parametrize("n", [2, 8])
def test_rank_gathers_match_jax(data_dir, n):
    """Each rank's gather of its slice of a locality batch (rows made
    local on the host) equals its shard of JAX's shard_map gather, every
    row: padded rows naming another rank's image clamp alike."""
    jds, pds = _ds(data_dir)
    mesh = j_make_mesh(n)
    jcache = JShardedCache.build(jds.store, mesh)
    parts = jcache.partitions()[jds.table.image_row]
    jbatch = next(iter(JBatcher(jds, 16, shuffle=True, seed=3,
                                materialize=False, partitions=parts,
                                n_partitions=n)))
    f, b = jax.jit(jcache.gather_fn())(jcache.features, jcache.boxes,
                                       j_shard_batch(jbatch, mesh)
                                       ["image_row"])
    want = np.concatenate([np.asarray(f), np.asarray(b)], -1)
    per = 16 // n
    for c in _shards(pds.store, n):
        pbatch = next(iter(Batcher(pds, 16, shuffle=True, seed=3,
                                   materialize=False, partitions=parts,
                                   n_partitions=n)))
        rows = c.local_rows(pbatch["image_row"][c.rank * per:
                                                (c.rank + 1) * per])
        image = make_image_fn(c, "float32")(torch.from_numpy(rows))
        mine = slice(c.rank * per, (c.rank + 1) * per)
        np.testing.assert_array_equal(image.nodes.numpy(), want[mine])
        np.testing.assert_array_equal(image.boxes.numpy(),
                                      np.asarray(b)[mine])


def test_local_rows_subtract_the_shard_start(data_dir):
    _, pds = _ds(data_dir)
    c = _shards(pds.store, 2)[1]
    assert c.shard_size == 10
    np.testing.assert_array_equal(c.local_rows(np.array([10, 19, 3])),
                                  [0, 9, -7])
    assert c.local_rows(np.array([12])).dtype == np.int32


@pytest.mark.parametrize("budget,want", [
    (TABLE, "tuple"), (TABLE - 1, "ShardedFeatureCache"),
    (TABLE // 2, "ShardedFeatureCache"), (TABLE // 2 - 1, "NoneType")])
def test_cache_mode_follows_the_per_card_budget_as_jax(data_dir, budget,
                                                       want):
    """Over two ranks: replicated when the table fits one card, sharded
    when only half of it does, else host mode; JAX picks alike on its
    2-device mesh."""
    jds, pds = _ds(data_dir)
    got = make_feature_cache(pds, TrainConfig(device_cache_bytes=budget),
                             "float32", mesh=Mesh(0, 2, torch.device("cpu")))
    theirs = j_loop.make_feature_cache(
        jds, j_make_mesh(2), JTrainConfig(device_cache_bytes=budget,
                                          pallas_gather=False), "float32")
    assert type(got).__name__ == type(theirs).__name__ == want
    # one rank: the sharded mode does not exist
    alone = make_feature_cache(pds, TrainConfig(device_cache_bytes=budget),
                               "float32", "cpu")
    assert type(alone).__name__ == ("tuple" if want == "tuple"
                                    else "NoneType")


def test_int8_cache_stays_replicated(data_dir):
    """int8 is replicated only: a budget that takes the int8 table gives
    the quantized cache on every rank; one below it falls to the compute
    dtype's modes (here, under half the f32 table, host mode), as in
    JAX."""
    jds, pds = _ds(data_dir)
    mesh = Mesh(0, 2, torch.device("cpu"))
    int8_bytes = 20 * N_OBJ * FEAT + 20 * N_OBJ * 4 + 20 * N_OBJ * 4 * 4
    assert int8_bytes < TABLE // 2
    for budget, want in ((int8_bytes, QuantizedFeatureCache),
                         (int8_bytes - 1, type(None))):
        got = make_feature_cache(
            pds, TrainConfig(device_cache_bytes=budget,
                             feature_cache_dtype="int8"), "float32",
            mesh=mesh)
        theirs = j_loop.make_feature_cache(
            jds, j_make_mesh(2), JTrainConfig(
                device_cache_bytes=budget, feature_cache_dtype="int8",
                pallas_gather=False), "float32")
        assert isinstance(got, want)
        assert type(theirs).__name__ == want.__name__


def test_bf16_reduce_refused_for_the_sharded_cache(data_dir):
    jds, pds = _ds(data_dir)
    shard = _shards(pds.store, 2)[0]
    ok, why = supports_bf16_reduce(shard)
    j_ok, j_why = j_supports_bf16(j_make_mesh(2), JShardedCache.build(
        jds.store, j_make_mesh(2)))
    assert (ok, why) == (j_ok, j_why) == (
        False, "a ShardedFeatureCache feature cache")
    assert supports_bf16_reduce(None) == (True, None)
    # the step refuses before any collective runs
    model = build_model(ModelConfig(hid_dim=16, combined_dim=8, n_kernels=2,
                                    neighbourhood_size=3,
                                    compute_dtype="float32"), pds,
                        device="cpu")
    optimizer, _ = make_optimizer(model, TrainConfig(), 1)
    batch = next(iter(Batcher(pds, 8, materialize=False)))
    batch["image_row"] = shard.local_rows(batch["image_row"])
    with pytest.raises(ValueError, match="does not support a Sharded"):
        train_step(model, optimizer, None, batch,
                   image_fn=make_image_fn(shard, "float32"),
                   mesh=Mesh(0, 2, torch.device("cpu"), "gloo"),
                   n_valid=16.0, grad_reduce_dtype="bfloat16")
