"""The port's evaluate against the JAX package's, on CPU.

The same synthetic splits (the JAX generator's files, the port's
in-memory copy) and the same weights (a JAX parameter tree through
state_dict_from_jax_params) give the same EvalAI result list and
accuracy, with JAX running its Pallas kernels and its blocked row gather
in interpret mode (the weights: a short port training run, imported
by the JAX package as a reference checkpoint); then the port's resident and streaming paths, the
adjacencies, max_batches, the pad slot, the unannotated test split and
the result.json schema.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_project_tpu.config import ModelConfig as JModelConfig
from vqa_project_tpu.config import TrainConfig as JTrainConfig
from vqa_project_tpu.data import GraphVQADataset as JDataset
from vqa_project_tpu.data.synthetic import generate_synthetic_vqa as j_gen
from vqa_project_tpu.models.torch_import import import_torch_state_dict
from vqa_project_tpu.train.loop import build_model as j_build_model
from vqa_project_tpu.train.loop import evaluate as j_evaluate
from vqa_project_tpu_torch.config import ModelConfig, TrainConfig
from vqa_project_tpu_torch.data import generate_synthetic_vqa
from vqa_project_tpu_torch.models import state_dict_from_jax_params
from vqa_project_tpu_torch.train import (build_model, evaluate, fit,
                                         make_feature_cache)
from vqa_project_tpu_torch.train.steps import QuantizedFeatureCache

N_OBJ, FEAT, QLEN, BS = 8, 24, 10, 10
GEN = dict(n_images=12, n_questions=96, n_obj=N_OBJ, feat_dim=FEAT,
           q_vocab=20, n_answers=8, seed=1000)
MODEL = dict(emb_dim=16, hid_dim=24, combined_dim=16, n_kernels=3,
             neighbourhood_size=4, dropout=0.1, max_qlen=QLEN,
             compute_dtype="float32")


@pytest.fixture(autouse=True)
def flush_denormals():
    """XLA:CPU flushes denormals; run torch's CPU kernels the same way
    (see tests/test_torch_model.py)."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Both packages' splits, the JAX model and its parameters."""
    d = str(tmp_path_factory.mktemp("synth_eval"))
    j_gen(d, with_test=True, **GEN)
    jds = {s: JDataset.vqa2(d, s, n_obj=N_OBJ, max_qlen=QLEN)
           for s in ("val", "test")}
    pds = generate_synthetic_vqa(**GEN, max_qlen=QLEN, with_test=True)
    jmodel = j_build_model(JModelConfig(**MODEL, use_pallas=True),
                           jds["val"])
    # weights that answer differently per question: a short run of the
    # port's fit, imported as a reference checkpoint by the JAX package
    trained, _, _ = fit(TrainConfig(lr=5e-3, epochs=12, batch_size=12,
                                    eval_interval=0, log_interval=1000,
                                    save_dir=d),
                        ModelConfig(**MODEL), pds["train"], device="cpu")
    params = import_torch_state_dict(trained.state_dict())
    return jds, pds, jmodel, params


def _port_model(pds, params):
    model = build_model(ModelConfig(**MODEL), pds["val"], device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params))
    return model


def _pad_seeking(params):
    """Params whose classifier bias sends every argmax to the answer
    vocabulary's pad slot (the last column, which has no word)."""
    params = jax.tree_util.tree_map(lambda x: x, params)
    b = np.array(params["params"]["out_2"]["b"])
    b[-1] = 1e6
    params["params"]["out_2"]["b"] = b
    return params


def _j_eval(setup, split, tmp_path, **kw):
    jds, _, jmodel, params = setup
    return j_evaluate(jmodel, kw.pop("params", params), jds[split], BS,
                      result_path=str(tmp_path / "j.json"), num_devices=1,
                      train_cfg=JTrainConfig(batch_size=BS,
                                             pallas_gather=True), **kw)


@pytest.mark.parametrize("split", ["val", "test"])
def test_evaluate_matches_jax(setup, tmp_path, split):
    _, pds, _, params = setup
    j_acc, j_result, _ = _j_eval(setup, split, tmp_path)
    model = _port_model(pds, params)
    path = tmp_path / "result.json"
    acc, result, adj = evaluate(model, pds[split], BS,
                                result_path=str(path), device="cpu")
    assert adj is None
    assert result == j_result
    assert acc == pytest.approx(j_acc, abs=1e-4)
    assert len(result) == pds[split].n_questions
    assert json.loads(path.read_text()) == result
    if split == "test":           # unannotated: every score is 0
        assert acc == j_acc == 0.0


@pytest.mark.parametrize("cache_dtype", ["auto", "int8"])
def test_resident_equals_streaming(setup, tmp_path, cache_dtype):
    _, pds, _, params = setup
    model = _port_model(pds, params)
    ds = pds["val"]
    assert ds.n_questions % BS            # a padded final batch
    resident = evaluate(model, ds, BS, result_path=None, device="cpu",
                        train_cfg=TrainConfig(
                            feature_cache_dtype=cache_dtype))
    streaming = evaluate(model, ds, BS, result_path=None, device="cpu",
                         cache=None)
    if cache_dtype == "auto":         # f32 tables: the same inputs
        assert resident[1] == streaming[1]
        assert resident[0] == pytest.approx(streaming[0], abs=1e-4)
    else:                             # quantized inputs: same questions
        assert ([r["question_id"] for r in resident[1]]
                == [r["question_id"] for r in streaming[1]])


def test_int8_cache_is_chosen(setup):
    _, pds, _, _ = setup
    cache = make_feature_cache(pds["val"],
                               TrainConfig(feature_cache_dtype="int8"),
                               "float32", device="cpu")
    assert isinstance(cache, QuantizedFeatureCache)
    assert cache.features.dtype == torch.int8
    assert tuple(cache.scales.shape) == pds["val"].store.features.shape[:2]


def test_collect_adjacency_matches_jax(setup, tmp_path):
    _, pds, _, params = setup
    _, j_result, j_adj = _j_eval(setup, "val", tmp_path,
                                 collect_adjacency=True, max_batches=2)
    model = _port_model(pds, params)
    _, result, adj = evaluate(model, pds["val"], BS, result_path=None,
                              collect_adjacency=True, max_batches=2,
                              device="cpu")
    assert result == j_result and len(result) == 2 * BS
    assert set(adj) == set(j_adj) == set(range(2 * BS))
    for row, a in adj.items():
        want = np.asarray(j_adj[row])
        assert a.shape == want.shape == (N_OBJ, N_OBJ)
        err = np.abs(a - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 1e-5, (row, err)


@pytest.mark.parametrize("cache", ["device", "host"])
def test_max_batches(setup, tmp_path, cache):
    _, pds, _, params = setup
    j_acc, j_result, _ = _j_eval(setup, "val", tmp_path, max_batches=1)
    model = _port_model(pds, params)
    kw = {} if cache == "device" else {"cache": None}
    acc, result, _ = evaluate(model, pds["val"], BS, result_path=None,
                              max_batches=1, device="cpu", **kw)
    assert result == j_result and len(result) == BS
    assert acc == pytest.approx(j_acc, abs=1e-4)
    assert evaluate(model, pds["val"], BS, result_path=None, max_batches=0,
                    device="cpu", **kw)[:2] == (0.0, [])


@pytest.mark.parametrize("cache", ["device", "host"])
def test_pad_slot_never_emitted(setup, tmp_path, cache):
    """A checkpoint whose logits peak on the pad slot must still answer
    with words: the slot is masked in both paths, as in JAX."""
    _, pds, _, params = setup
    params = _pad_seeking(params)
    _, j_result, _ = _j_eval(setup, "val", tmp_path, params=params)
    model = _port_model(pds, params)
    kw = {} if cache == "device" else {"cache": None}
    _, result, _ = evaluate(model, pds["val"], BS, result_path=None,
                            device="cpu", **kw)
    words = set(pds["val"].a_itow.values())
    assert len(result) == pds["val"].n_questions
    assert all(r["answer"] in words for r in result)
    assert result == j_result


def test_result_json_schema(setup, tmp_path):
    _, pds, _, params = setup
    model = _port_model(pds, params)
    ds = pds["test"]
    path = tmp_path / "result.json"
    evaluate(model, ds, BS, result_path=str(path), device="cpu")
    loaded = json.loads(path.read_text())
    assert isinstance(loaded, list) and len(loaded) == ds.n_questions
    assert [r["question_id"] for r in loaded] == [
        row["question_id"] for row in ds.vqa]
    for r in loaded:
        assert set(r) == {"question_id", "answer"}
        assert isinstance(r["question_id"], int)
        assert r["answer"] in ds.a_itow.values()


def test_evaluate_defaults_to_the_card(setup):
    _, pds, _, params = setup
    model = _port_model(pds, params)
    with pytest.raises((RuntimeError, ValueError)):
        evaluate(model, pds["val"], BS, result_path=None)
