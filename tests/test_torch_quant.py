"""int8 serving on the CPU against the JAX package's ``ops/quant.py`` and
its ``quantized_inference`` model: the weight codes (equal) and scales,
the int8 product (int32 sums equal, padded shapes included, and the CUDA
path's padding exact through torch's CPU ``_int_mm``), the quantized
forward on the same weights, and the refusals: no train-mode forward, no
merged block, no product on a device other than the CPU or CUDA, no
unpadded weight on the CUDA path, no card asked for without one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_model import CFG, make_batch
from vqa_project_tpu.models import GraphVQAModel as JaxModel
from vqa_project_tpu.ops import quant as j_quant
from vqa_project_tpu_torch.config import ModelConfig
from vqa_project_tpu_torch.models import (GraphVQAModel,
                                          state_dict_from_jax_params)
from vqa_project_tpu_torch.ops.quant import (int8_matmul, int8_sums,
                                             pad_int8_weight, padded_int_mm,
                                             quantize_activation,
                                             quantize_state_dict_for_serving,
                                             quantize_weight)

# a rounding tie that XLA's division splits the other way may flip one
# code by one; at most this share of codes may differ so
TIE_SHARE = 1e-4


@pytest.fixture(autouse=True)
def flush_denormals():
    """XLA:CPU flushes denormals; run torch's CPU kernels the same way
    (see tests/test_torch_model.py)."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _same_codes(got: np.ndarray, want: np.ndarray, what: str) -> None:
    diff = got.astype(np.int32) - want.astype(np.int32)
    flips = int(np.count_nonzero(diff))
    print(f"{what}: {flips} of {diff.size} codes differ by one")
    assert np.abs(diff).max(initial=0) <= 1, what
    assert flips <= TIE_SHARE * diff.size, (what, flips)


def test_weight_codes_match_jax(rng):
    w = rng.normal(size=(2052, 256)).astype(np.float32)
    w[:, 3] = 0.0                                   # an all-zero column
    w[7, 5] = 127.0 * 2.5                           # exact .5 ties
    w[9, 5] = 0.5
    jq, js = j_quant.quantize_weight(jnp.asarray(w))
    q, scale = quantize_weight(torch.from_numpy(w))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    _same_codes(q.numpy(), np.asarray(jq), "quantize_weight")
    np.testing.assert_allclose(scale.numpy(), np.asarray(js), rtol=1e-6)


def _jax_params(seed=0):
    model = JaxModel(cfg=dataclasses.replace(CFG, use_pallas=False))
    q, image, qlen = make_batch(np.random.default_rng(seed), 2)
    return model.init(jax.random.key(seed), q, image, qlen)


def test_state_dict_quantization_matches_jax():
    """quantize_state_dict_for_serving on the port's state_dict of JAX's
    weights against quantize_params_for_serving, once transposed: codes
    equal, scales (g / ||v|| folded in) within 1e-6."""
    params = _jax_params()
    jq = j_quant.quantize_params_for_serving(params)["params"]
    got = quantize_state_dict_for_serving(state_dict_from_jax_params(params))
    layers = {"adjacency_1.edge_layer_1": jq["adjacency_1"]["edge_layer_1"],
              "adjacency_1.edge_layer_2": jq["adjacency_1"]["edge_layer_2"],
              "out_1": jq["out_1"], "out_2": jq["out_2"]}
    for name, leaf in layers.items():
        _same_codes(got[f"{name}.weight_q"].numpy(),
                    np.asarray(leaf["v_q"]).T, name)
        np.testing.assert_allclose(got[f"{name}.weight_scale"].numpy(),
                                   np.asarray(leaf["v_scale"]), rtol=1e-6)
        np.testing.assert_array_equal(got[f"{name}.bias"].numpy(),
                                      np.asarray(leaf["b"]))
        assert f"{name}.weight_v" not in got and f"{name}.weight_g" not in got
    for conv in ("graph_convolution_1", "graph_convolution_2"):
        _same_codes(got[f"{conv}.conv_weights_q"].numpy(),
                    np.asarray(jq[conv]["conv_kernels_q"]).T, conv)
        np.testing.assert_allclose(
            got[f"{conv}.conv_weights_scale"].numpy(),
            np.asarray(jq[conv]["conv_kernels_scale"]), rtol=1e-6)
        assert not any(k.startswith(f"{conv}.conv_weights.") for k in got)
    with pytest.raises(ValueError, match="quantizable layers"):
        quantize_state_dict_for_serving({"wembed.weight": torch.zeros(2, 2)})


def _jax_sums(x, w_q):
    """The int32 sums of the JAX package's int8_matmul (its body up to the
    dot)."""
    x = jnp.asarray(x, jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(x)), 1e-12) / 127.0
    x_q = jnp.clip(jnp.round(x / sx), -127, 127).astype(jnp.int8)
    return np.asarray(jax.lax.dot_general(
        x_q, w_q, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))


# serving products' depths and widths: out_2 (3001 -> 3001), conv1 and
# edge_layer_1's node half (2052 deep), the rest multiples of 8
PRODUCTS = [(2052, 3001), (3001, 3001), (1024, 512)]


@pytest.mark.parametrize("m", [1, 16])
@pytest.mark.parametrize("k,n", PRODUCTS)
def test_int8_matmul_matches_jax(rng, m, k, n):
    x = (rng.normal(size=(m, k)) * rng.uniform(0.1, 3)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    jw, js = j_quant.quantize_weight(jnp.asarray(w))
    want = np.asarray(j_quant.int8_matmul(jnp.asarray(x), jw, js))
    want_sums = _jax_sums(x, jw)

    q, scale = quantize_weight(torch.from_numpy(w))
    padded = pad_int8_weight(q.t())
    assert padded.shape == (-(-n // 8) * 8, -(-k // 8) * 8)
    xt = torch.from_numpy(x)
    x_q, _ = quantize_activation(xt)
    sums = int8_sums(x_q, padded.t())
    np.testing.assert_array_equal(sums[:, :n].numpy(), want_sums)
    assert not sums[:, n:].any()
    # the CUDA path's padding (to > 16 rows and depth, width % 8) through
    # torch's CPU _int_mm: the same sums
    assert torch.equal(padded_int_mm(x_q, padded.t()), sums)
    for w_q in (q, padded.t()):                 # unpadded or padded
        got = int8_matmul(xt, w_q, scale)
        assert got.shape == (m, n) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def _models(params, compute_dtype="float32"):
    cfg = dataclasses.replace(CFG, use_pallas=False,
                              compute_dtype=compute_dtype)
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    pcfg = ModelConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                          if k in fields})
    float_model = GraphVQAModel(pcfg, device="cpu")
    float_model.load_state_dict(state_dict_from_jax_params(params))
    q8 = GraphVQAModel(dataclasses.replace(pcfg, quantized_inference=True),
                       device="cpu")
    q8.load_state_dict(quantize_state_dict_for_serving(
        float_model.state_dict()))
    jmodel = JaxModel(cfg=dataclasses.replace(cfg, quantized_inference=True))
    return q8, jmodel, j_quant.quantize_params_for_serving(params)


def test_quantized_forward_matches_jax(rng):
    """The port's int8 model against JAX's ``quantized_inference`` model on
    the same weights, f32 compute. Each product's activation codes come
    from its own f32 input, which the two sides compute in other orders
    of summation: a code of a later layer may flip at a rounding tie, so
    the logits are held to 1e-3 of their largest magnitude and top-1 to
    98% of the questions."""
    q8, jmodel, jparams = _models(_jax_params(1))
    q, image, qlen = make_batch(rng, 128)
    want, want_adj, _ = jmodel.apply(jparams, q, image, qlen)
    want = np.asarray(want)
    got, adj, _ = q8(*(torch.from_numpy(np.array(a))
                       for a in (q, image, qlen)))
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-3 * float(np.abs(want).max()), err
    agree = float((got.numpy().argmax(-1) == want.argmax(-1)).mean())
    assert agree >= 0.98, agree
    np.testing.assert_allclose(adj.numpy(), np.asarray(want_adj),
                               rtol=1e-3, atol=1e-3 * float(
                                   np.abs(want_adj).max()))


def test_quantized_model_buffers_follow_a_load():
    """The padded operands are made again when a state_dict is loaded, and
    move with the model."""
    q8, _, _ = _models(_jax_params(2))
    layer = q8.out_2
    assert torch.equal(layer._operand_x[:CFG.out_dim, :CFG.out_dim],
                       layer.weight_q)
    assert layer._operand_x.shape == (-(-CFG.out_dim // 8) * 8,) * 2
    edge = q8.adjacency_1.edge_layer_1
    assert torch.equal(edge._operand_shared[:CFG.combined_dim, :CFG.hid_dim],
                       edge.weight_q[:, CFG.feat_dim:])
    conv = q8.graph_convolution_1
    assert torch.equal(conv._operand[:, :CFG.feat_dim], conv.conv_weights_q)
    assert not any("_operand" in k for k in q8.state_dict())


def test_refusals():
    pcfg = ModelConfig(vocab_size=10, emb_dim=8, feat_dim=12, hid_dim=16,
                       out_dim=7, combined_dim=8, n_kernels=4,
                       neighbourhood_size=3, n_obj=5, max_qlen=6,
                       compute_dtype="float32", quantized_inference=True)
    with pytest.raises(ValueError, match="merged block"):
        GraphVQAModel(dataclasses.replace(pcfg, merged_block=True),
                      device="cpu")
    model = GraphVQAModel(pcfg, device="cpu")
    q = torch.ones((2, 6), dtype=torch.int64)
    image = torch.rand(2, 5, 12)
    qlen = torch.full((2,), 3, dtype=torch.int32)
    model(q, image, qlen)                       # serving runs
    with pytest.raises(ValueError, match="serves only"):
        model(q, image, qlen, train=True)


def test_no_fallback(monkeypatch):
    """A product on another device than the CPU or CUDA, or a CUDA-path
    product on an unpadded weight, raises; a quantized model asked for
    the card without one raises."""
    x = torch.zeros((4, 12), dtype=torch.int8, device="meta")
    w = torch.zeros((12, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        int8_sums(x, w)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        int8_matmul(x.float(), w, torch.ones(8, device="meta"))
    with pytest.raises(ValueError, match="pad_int8_weight"):
        padded_int_mm(torch.zeros((4, 12), dtype=torch.int8),
                      torch.zeros((12, 8), dtype=torch.int8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(vocab_size=10, emb_dim=8, feat_dim=12, hid_dim=16,
                      out_dim=7, combined_dim=8, n_kernels=4,
                      neighbourhood_size=3, n_obj=5, max_qlen=6,
                      quantized_inference=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GraphVQAModel(cfg)
