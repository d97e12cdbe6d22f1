"""The device feature tables (``data.feature_cache``) on the CPU: every
format, ``parallel.ShardedFeatureCache`` with them, answers the same
questions (its Batcher kwargs, its local rows, the bf16 reduce, its
gather against the plain gathers of the store's rows); a bare
(features, boxes) pair is a ``FeatureCache`` to ``make_image_fn`` and to
``evaluate``; ``make_feature_cache`` builds the table that the model's
class names; ``val_feature_cache`` shares the train table only where
both splits read one store."""

import numpy as np
import pytest
import torch

from vqa_project_tpu_torch.config import ModelConfig, TrainConfig
from vqa_project_tpu_torch.data.feature_cache import (FeatureCache,
                                                      QuantizedFeatureCache,
                                                      RegionCache)
from vqa_project_tpu_torch.data.store import region_counts
from vqa_project_tpu_torch.data.synthetic import generate_synthetic_vqa
from vqa_project_tpu_torch.models import MODELS
from vqa_project_tpu_torch.ops.gather_rows import (gather_image_reference,
                                                   gather_rows_reference)
from vqa_project_tpu_torch.parallel import Mesh, ShardedFeatureCache
from vqa_project_tpu_torch.train import loop
from vqa_project_tpu_torch.train.steps import (make_image_fn,
                                               supports_bf16_reduce)

CPU = torch.device("cpu")
N_IMAGES = 10
FORMATS = {c.__name__: c for c in (FeatureCache, QuantizedFeatureCache,
                                   RegionCache, ShardedFeatureCache)}


@pytest.fixture(scope="module")
def synthetic():
    return generate_synthetic_vqa(n_images=N_IMAGES, n_questions=64, n_obj=6,
                                  feat_dim=20, q_vocab=30, n_answers=8,
                                  seed=5, max_qlen=7, with_test=True)


def _build(name, store, mesh):
    if name == "ShardedFeatureCache":
        return ShardedFeatureCache.build(store, mesh)
    if name == "RegionCache":
        return RegionCache.build(store, TrainConfig(), "float32", CPU, mesh)
    dtype = "int8" if name == "QuantizedFeatureCache" else "float32"
    return FeatureCache.build(store, TrainConfig(feature_cache_dtype=dtype),
                              "float32", CPU, mesh)


@pytest.mark.parametrize("name", FORMATS)
def test_every_format_answers_the_same_questions(synthetic, name):
    ds = synthetic["train"]
    store = ds.store
    mesh = Mesh(1, 2, CPU)     # rank 1 of 2 data ranks
    cache = _build(name, store, mesh)
    assert type(cache) is FORMATS[name]
    sharded = name == "ShardedFeatureCache"
    # the bf16 reduce, and the rule that reads it
    assert cache.bf16_reduce is (not sharded)
    assert supports_bf16_reduce(cache) == (
        (False, f"a {name} feature cache") if sharded else (True, None))
    # what the Batcher must know of the table
    kwargs = cache.batcher_kwargs(ds, mesh)
    if name == "RegionCache":
        assert kwargs.keys() == {"region_counts"}
        np.testing.assert_array_equal(kwargs["region_counts"],
                                      region_counts(store.features))
    elif sharded:
        assert kwargs["n_partitions"] == 2
        np.testing.assert_array_equal(
            kwargs["partitions"], ds.table.image_row // cache.shard_size)
    else:
        assert kwargs == {}
    # a global batch's image rows as rows of this rank's table
    rows = np.array([7, 5, 9], np.int64)
    local = cache.local_rows(rows)
    np.testing.assert_array_equal(local, rows - 5 if sharded else rows)
    # the gather, against the plain gathers of the store's rows
    feats = torch.from_numpy(np.asarray(store.features))
    boxes = torch.from_numpy(np.asarray(store.boxes))
    want_rows = torch.from_numpy(rows).to(torch.int32)
    got_rows = torch.from_numpy(np.asarray(local)).to(torch.int32)
    if name == "RegionCache":
        image = cache.gather_fn("float32")(got_rows)
        assert torch.equal(image.feats,
                           gather_rows_reference(feats, want_rows))
        assert torch.equal(image.count, cache.counts[want_rows.long()])
        return
    for merged in (False, True):
        image = cache.gather_fn("float32", merged)(got_rows)
        if name == "QuantizedFeatureCache":
            want = gather_image_reference(cache.features, cache.boxes,
                                          want_rows, cache.scales,
                                          torch.float32, padded=merged)
        else:
            want = gather_image_reference(feats, boxes, want_rows,
                                          padded=merged)
        assert torch.equal(image.nodes, want.nodes)
        assert torch.equal(image.boxes, want.boxes)


def test_a_bare_pair_is_a_feature_cache(synthetic):
    """The benchmark's form: ``make_image_fn((features, boxes), dtype)``
    and ``evaluate(..., cache=(features, boxes))`` run as a
    ``FeatureCache`` does, and the image function carries its cache."""
    ds = synthetic["val"]
    pair = (torch.from_numpy(np.asarray(ds.store.features)),
            torch.from_numpy(np.asarray(ds.store.boxes)))
    fn = make_image_fn(pair, "float32")
    assert type(fn.feature_cache) is FeatureCache
    rows = torch.tensor([3, 0, 9], dtype=torch.int32)
    assert torch.equal(
        fn(rows).nodes,
        make_image_fn(FeatureCache(*pair), "float32")(rows).nodes)
    assert make_image_fn(None, "float32") is None
    model = loop.build_model(
        ModelConfig(hid_dim=16, combined_dim=8, n_kernels=2,
                    neighbourhood_size=3, compute_dtype="float32"),
        ds, device="cpu")
    acc, result, _ = loop.evaluate(model, ds, 8, result_path=None,
                                   cache=pair, device="cpu")
    acc2, result2, _ = loop.evaluate(model, ds, 8, result_path=None,
                                     cache=FeatureCache(*pair), device="cpu")
    assert result == result2 and acc == acc2
    assert len(result) == len(ds.table.qid)


@pytest.mark.parametrize("arch", [*sorted(MODELS), "probe"])
def test_make_feature_cache_builds_the_models_table(synthetic, arch,
                                                    monkeypatch):
    """The table is the one the class of ``arch``'s model names, reached
    through ``models.MODELS``."""
    ds = synthetic["train"]
    if arch == "probe":
        calls = []

        class Probe:
            """A table format that records its build."""

            @classmethod
            def build(cls, *args):
                calls.append(args)
                return "probe"

        monkeypatch.setitem(MODELS, "probe", type(
            "ProbeModel", (), {"feature_cache": Probe}))
        cfg = TrainConfig()
        assert loop.make_feature_cache(ds, cfg, "bfloat16", "cpu",
                                       arch="probe") == "probe"
        assert calls == [(ds.store, cfg, "bfloat16", CPU, None)]
        return
    cache = loop.make_feature_cache(ds, TrainConfig(), "float32", "cpu",
                                    arch=arch)
    assert type(cache) is MODELS[arch].feature_cache
    assert type(cache) is {"graph": FeatureCache, "mcan": RegionCache}[arch]


def test_val_feature_cache_shares_one_store(synthetic):
    train, val, test = (synthetic[k] for k in ("train", "val", "test"))
    cfg = TrainConfig()
    cache = loop.make_feature_cache(train, cfg, "float32", "cpu")
    assert loop.val_feature_cache(train, val, cache, cfg, "float32",
                                  "cpu") is cache
    own = loop.val_feature_cache(train, test, cache, cfg, "float32", "cpu")
    assert type(own) is FeatureCache and own is not cache
    assert own.features.shape[0] == test.store.features.shape[0]
