"""The cache-mode image gather (kernel G's redesign) on CPU: its plain
version against the JAX package's image function, the model fed its
``NodeImage`` against the same model fed the (features, boxes) pair, and
the wrapper's CPU dispatch and refusals.

Every comparison is bit for bit: a gather moves data, and each cast or
dequantization rounds once, as in the JAX step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cache import _cache_and_batch
from tests.test_torch_train import _port_cfg
from vqa_project_tpu.train import steps as j_steps
from vqa_project_tpu_torch.models import GraphVQAModel
from vqa_project_tpu_torch.ops.gather_rows import (NodeImage,
                                                   gather_image_reference,
                                                   gather_image_rows,
                                                   node_row_stride)
from vqa_project_tpu_torch.ops.quant import quantize_feature_table
from vqa_project_tpu_torch.train import QuantizedFeatureCache, make_image_fn

# (table dtype, node dtype): every pair make_feature_cache can build
PAIRS = [("float32", "float32"), ("float32", "bfloat16"),
         ("bfloat16", "bfloat16"), ("bfloat16", "float32"),
         ("int8", "bfloat16"), ("int8", "float32")]


@pytest.fixture(autouse=True)
def flush_denormals():
    """XLA:CPU flushes denormals; run torch's CPU kernels the same way
    (see tests/test_torch_model.py)."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _tables(rng, n=9, k=5, f=16):
    """An f32 feature table and its xyxy boxes."""
    feats = rng.standard_normal((n, k, f)).astype(np.float32)
    xy1 = rng.uniform(0, 0.5, size=(n, k, 2))
    wh = rng.uniform(0.05, 0.5, size=(n, k, 2))
    return feats, np.concatenate([xy1, xy1 + wh], -1).astype(np.float32)


def _clamped_rows(n):
    """Rows 0 and n-1, a duplicate, and -1 / n / -4 clamped."""
    return np.array([3, 0, n - 1, -1, n, 3, 5, -4, 2 * n], np.int32)


@pytest.mark.parametrize("padded", [False, True], ids=["contiguous",
                                                       "padded"])
@pytest.mark.parametrize("k,f", [(5, 16), (7, 24), (8, 16)])
@pytest.mark.parametrize("table_dtype,node_dtype", PAIRS)
def test_reference_matches_jax_image_fn(rng, table_dtype, node_dtype, k, f,
                                        padded):
    """gather_image_reference against JAX's make_image_fn, its pair
    concatenated in the compute dtype as the JAX model does
    (models/graph_vqa.py:368-372); the boxes in f32; the pad columns 0."""
    feats, boxes = _tables(rng, k=k, f=f)
    rows = _clamped_rows(feats.shape[0])
    jdt = jnp.dtype(node_dtype)
    dt = getattr(torch, node_dtype)
    scales = None
    if table_dtype == "int8":
        q, s = quantize_feature_table(feats)
        jcache = j_steps.QuantizedFeatureCache(
            features=jnp.asarray(q), scales=jnp.asarray(s),
            boxes=jnp.asarray(boxes), kf=None, out_dtype=node_dtype)
        table, scales = torch.from_numpy(q), torch.from_numpy(s)
    else:
        jcache = (jnp.asarray(feats).astype(table_dtype),
                  jnp.asarray(boxes))
        table = torch.from_numpy(feats).to(getattr(torch, table_dtype))
    image_fn, arrays = j_steps.make_image_fn(jcache)
    want_f, want_b = image_fn(arrays, jnp.asarray(rows))
    want = np.asarray(jnp.concatenate(
        [want_f.astype(jdt), want_b.astype(jdt)], axis=-1
    ).astype(jnp.float32))

    got = gather_image_reference(table, torch.from_numpy(boxes),
                                 torch.from_numpy(rows), scales, dt, padded)
    assert isinstance(got, NodeImage)
    assert got.nodes.dtype == dt and got.boxes.dtype == torch.float32
    assert tuple(got.nodes.shape) == (len(rows), k, f + 4)
    np.testing.assert_array_equal(got.nodes.float().numpy(), want)
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want_b))
    ld = node_row_stride(f + 4, padded)
    assert got.nodes.stride()[:2] == (k * ld, ld)
    if padded:
        assert ld % 8 == 0 and ld > f + 4
        base = got.nodes.as_strided((len(rows), k, ld),
                                    (k * ld, ld, 1))
        assert not base[..., f + 4:].any()
    # the wrapper's CPU dispatch is the plain version
    same = gather_image_rows(table, torch.from_numpy(boxes),
                             torch.from_numpy(rows), scales, dt, padded)
    assert torch.equal(same.nodes, got.nodes)
    assert torch.equal(same.boxes, got.boxes)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("merged", [False, True], ids=["unmerged",
                                                       "merged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_node_image_equals_pair(rng, dtype, merged, train):
    """GraphVQAModel fed the NodeImage of make_image_fn equals the same
    model fed the (features, boxes) pair, bit for bit: logits, adjacency,
    h_max_indices and, in training (dropout 0.3 from one generator
    seed), every parameter's gradient."""
    feats, boxes, host = _cache_and_batch(rng)
    model = GraphVQAModel(_port_cfg(compute_dtype=dtype, dropout=0.3,
                                    merged_block=merged),
                          device="cpu", seed=5)
    cdt = model.compute_dtype
    table, bx = torch.from_numpy(feats).to(cdt), torch.from_numpy(boxes)
    rows = torch.from_numpy(host["image_row"])
    q, qlen = torch.from_numpy(host["question"]), torch.from_numpy(host["qlen"])
    image_fn = make_image_fn((table, bx), dtype, merged)

    def run(image):
        model.zero_grad(set_to_none=True)
        if not train:
            return list(model(q, image, qlen)), []
        out = model(q, image, qlen, train=True,
                    generator=torch.Generator().manual_seed(3))
        out[0].sum().backward()
        return list(out), [p.grad.clone() for p in model.parameters()]

    node_image = image_fn(rows)
    assert isinstance(node_image, NodeImage)
    assert node_image.nodes.dtype == cdt
    assert node_image.nodes.stride(1) == node_row_stride(
        feats.shape[-1] + 4, merged)
    got, got_g = run(node_image)
    want, want_g = run((table.index_select(0, rows.long()),
                        bx.index_select(0, rows.long())))
    assert len(got_g) == len(want_g)
    for a, b in zip(got + got_g, want + want_g):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_model_refuses_node_image_in_another_dtype(rng):
    feats, boxes, host = _cache_and_batch(rng)
    model = GraphVQAModel(_port_cfg(compute_dtype="float32"), device="cpu")
    image = make_image_fn((torch.from_numpy(feats), torch.from_numpy(boxes)),
                          "bfloat16")(torch.from_numpy(host["image_row"]))
    with pytest.raises(TypeError, match="NodeImage nodes in"):
        model(torch.from_numpy(host["question"]), image,
              torch.from_numpy(host["qlen"]))


def test_make_image_fn_modes(rng):
    """Host mode has no image function; an int8 cache dequantizes in the
    gather (the same bits as the reference) and must do so to the
    model's compute dtype."""
    assert make_image_fn(None, "float32") is None
    feats, boxes = _tables(rng)
    q, s = quantize_feature_table(feats)
    qc = QuantizedFeatureCache(torch.from_numpy(q), torch.from_numpy(s),
                               torch.from_numpy(boxes), "bfloat16")
    rows = torch.from_numpy(_clamped_rows(feats.shape[0]))
    got = make_image_fn(qc, "bfloat16", merged_block=True)(rows)
    want = gather_image_reference(qc.features, qc.boxes, rows, qc.scales,
                                  torch.bfloat16, padded=True)
    assert torch.equal(got.nodes, want.nodes)
    assert torch.equal(got.boxes, want.boxes)
    with pytest.raises(ValueError, match="dequantizes to bfloat16"):
        make_image_fn(qc, "float32")


@pytest.mark.parametrize("padded", [False, True])
def test_cpu_dispatch_launches_nothing_and_fills_out(rng, padded):
    """On CPU tensors the wrapper takes its plain version and launches
    nothing; ``out=`` buffers filled with NaN come back written whole,
    their pad columns 0."""
    feats, boxes = _tables(rng, k=7, f=24)
    t, b = torch.from_numpy(feats).to(torch.bfloat16), torch.from_numpy(boxes)
    rows = torch.from_numpy(_clamped_rows(feats.shape[0]))
    before = gather_image_rows.launches
    ld = node_row_stride(28, padded)
    out = (torch.full((len(rows), 7, ld), float("nan"),
                      dtype=torch.bfloat16),
           torch.full((len(rows), 7, 4), float("nan")))
    got = gather_image_rows(t, b, rows, None, torch.bfloat16, padded,
                            out=out)
    want = gather_image_reference(t, b, rows, None, torch.bfloat16, padded)
    assert gather_image_rows.launches == before
    assert got.nodes.data_ptr() == out[0].data_ptr()
    assert got.boxes is out[1]
    assert torch.equal(got.nodes, want.nodes)
    assert torch.equal(got.boxes, want.boxes)
    assert not out[0][..., 28:].any() and not out[0].isnan().any()


def test_wrapper_refuses_bad_arguments(rng):
    feats, boxes = _tables(rng)
    t, b = torch.from_numpy(feats), torch.from_numpy(boxes)
    rows = torch.from_numpy(_clamped_rows(feats.shape[0]))
    q, s = (torch.from_numpy(a) for a in quantize_feature_table(feats))
    with pytest.raises(TypeError, match="int32"):
        gather_image_rows(t, b, rows.long())
    with pytest.raises(ValueError, match="rows on meta"):
        gather_image_rows(t, b, torch.empty(3, dtype=torch.int32,
                                            device="meta"))
    with pytest.raises(ValueError, match="boxes must be float32"):
        gather_image_rows(t, b[:-1], rows)
    with pytest.raises(ValueError, match="boxes must be float32"):
        gather_image_rows(t, b.to(torch.bfloat16), rows)
    with pytest.raises(ValueError, match="features must be"):
        gather_image_rows(t[..., 0], b, rows)
    with pytest.raises(TypeError, match="needs its scales"):
        gather_image_rows(q, b, rows)
    with pytest.raises(TypeError, match="needs its scales"):
        gather_image_rows(t, b, rows, s)
    with pytest.raises(ValueError, match="scales must be"):
        gather_image_rows(q, b, rows, s[:-1])
    with pytest.raises(TypeError, match="features must be"):
        gather_image_rows(t.double(), b, rows)
    with pytest.raises(TypeError, match="node_dtype"):
        gather_image_rows(t, b, rows, node_dtype=torch.float16)
    with pytest.raises(ValueError, match="out must be"):
        gather_image_rows(t, b, rows, padded=True, out=(
            torch.empty(len(rows), 5, 20), torch.empty(len(rows), 5, 4)))
