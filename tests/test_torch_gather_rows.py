"""Kernels F and G's plain versions and the int8 feature table against
the JAX package, on CPU.

The JAX Pallas gathers run in interpret mode; every comparison is bit
for bit, since a gather moves data and the int8 path rounds once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_project_tpu.ops.pallas.gather_rows import (gather_rows_blocked as
                                                    j_blocked,
                                                    gather_rows_dma,
                                                    pack_table)
from vqa_project_tpu.ops.quant import quantize_feature_table as j_quantize
from vqa_project_tpu.train import steps as j_steps
from vqa_project_tpu_torch.ops.gather_rows import (gather_rows_blocked,
                                                   gather_rows_packed,
                                                   gather_rows_reference)
from vqa_project_tpu_torch.ops.quant import quantize_feature_table


def _rows(rng, n, b):
    """b rows of an n-row table with row 0, row n-1 and a duplicate."""
    rows = rng.integers(0, n, b).astype(np.int32)
    rows[0], rows[-1] = 0, n - 1
    if b > 2:
        rows[1] = rows[-1]
    return rows


@pytest.mark.parametrize("b", [8, 16, 33])   # below, at, over the ring
def test_plain_gathers_match_jax_kernels(rng, b):
    n, k, f = 40, 4, 256          # k * f tile-aligns for the DMA kernel
    table = rng.standard_normal((n, k, f)).astype(np.float32)
    rows = _rows(rng, n, b)
    want_dma = np.asarray(gather_rows_dma(
        pack_table(jnp.asarray(table)), jnp.asarray(rows),
        interpret=True)).reshape(b, k, f)
    want_blocked = np.asarray(j_blocked(jnp.asarray(table),
                                        jnp.asarray(rows), interpret=True))
    t, r = torch.from_numpy(table), torch.from_numpy(rows)
    for got in (gather_rows_packed(t, r), gather_rows_blocked(t, r),
                gather_rows_reference(t, r)):
        np.testing.assert_array_equal(got.numpy(), want_dma)
    np.testing.assert_array_equal(want_blocked, want_dma)


@pytest.mark.parametrize("shape,dtype", [((9, 36, 4), np.float32),
                                         ((9, 5, 3), np.float32),
                                         ((9, 3, 7), np.int8)])
def test_blocked_any_row_shape(rng, shape, dtype):
    """G takes any row shape: the cache's boxes and rows that are not
    16-byte vectors."""
    table = (rng.standard_normal(shape) * 50).astype(dtype)
    rows = _rows(rng, shape[0], 6)
    got = gather_rows_blocked(torch.from_numpy(table), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), table[rows])


def test_out_of_range_rows_clamp_like_take_clip(rng):
    table = rng.standard_normal((7, 3, 8)).astype(np.float32)
    rows = np.array([-1, 7, 0, 6, 100, -2 ** 31, 2 ** 31 - 1], np.int32)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(rows),
                               axis=0, mode="clip"))
    t, r = torch.from_numpy(table), torch.from_numpy(rows)
    np.testing.assert_array_equal(gather_rows_packed(t, r).numpy(), want)
    np.testing.assert_array_equal(gather_rows_blocked(t, r).numpy(), want)


def _table_with_zero_rows(rng, n=12, k=5, f=24):
    feats = np.abs(rng.standard_normal((n, k, f))).astype(np.float32) * 3
    feats[2] = 0.0                # a whole padded image
    feats[5, 3] = 0.0             # one padding box
    feats[7, 1] *= -1             # negative values too
    return feats


def test_quantize_feature_table_matches_jax(rng):
    feats = _table_with_zero_rows(rng)
    q, s = quantize_feature_table(feats)
    jq, js = j_quantize(feats)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s.view(np.int32), js.view(np.int32))
    assert (s[2] == 1.0).all() and s[5, 3] == 1.0 and not q[2].any()
    # quantizing in chunks, as the cache upload does, changes no bit
    q2, s2 = zip(*(quantize_feature_table(feats[i:i + 5])
                   for i in range(0, len(feats), 5)))
    np.testing.assert_array_equal(np.concatenate(q2), q)
    np.testing.assert_array_equal(np.concatenate(s2), s)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_gather_matches_jax_image_fn(rng, out_dtype):
    """The int8 path of F (gather + per-box dequant + one rounding)
    against JAX's make_image_fn over its QuantizedFeatureCache, bit for
    bit, boxes through G."""
    feats = _table_with_zero_rows(rng)
    boxes = rng.uniform(size=(feats.shape[0], feats.shape[1], 4)
                        ).astype(np.float32)
    q, s = quantize_feature_table(feats)
    rows = np.array([3, 0, 11, 2, 3, 5, -4, 30], np.int32)
    image_fn, arrays = j_steps.make_image_fn(j_steps.QuantizedFeatureCache(
        features=jnp.asarray(q), scales=jnp.asarray(s),
        boxes=jnp.asarray(boxes), kf=None, out_dtype=out_dtype))
    want_f, want_b = image_fn(arrays, jnp.asarray(rows))
    dt = getattr(torch, out_dtype)
    got_f = gather_rows_packed(torch.from_numpy(q), torch.from_numpy(rows),
                               torch.from_numpy(s), dt)
    got_b = gather_rows_blocked(torch.from_numpy(boxes),
                                torch.from_numpy(rows))
    assert got_f.dtype == dt
    np.testing.assert_array_equal(
        got_f.float().numpy(), np.asarray(want_f.astype(jnp.float32)))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))


@pytest.mark.parametrize("out_dtype", [None, "float32", "bfloat16"])
def test_packed_gather_into_out_matches_jax(rng, out_dtype):
    """F's ``out=`` (the chip check's sentinel-filled outputs): a
    NaN-filled output is written whole with JAX's gather (out_dtype None:
    the f32 table copied; else the int8 table dequantized), the same
    tensor is returned, and an output of another shape or dtype is
    refused."""
    feats = _table_with_zero_rows(rng)
    rows = np.array([3, 0, 11, 2, 3, 5, -4, 30], np.int32)
    r = torch.from_numpy(rows)
    if out_dtype is None:
        want = np.asarray(jnp.take(jnp.asarray(feats), jnp.asarray(rows),
                                   axis=0, mode="clip"))
        args, dt = (torch.from_numpy(feats), r), torch.float32
    else:
        q, s = quantize_feature_table(feats)
        image_fn, arrays = j_steps.make_image_fn(
            j_steps.QuantizedFeatureCache(
                features=jnp.asarray(q), scales=jnp.asarray(s),
                boxes=jnp.zeros(feats.shape[:2] + (4,), jnp.float32),
                kf=None, out_dtype=out_dtype))
        want = np.asarray(image_fn(arrays, jnp.asarray(rows))[0].astype(
            jnp.float32))
        dt = getattr(torch, out_dtype)
        args = (torch.from_numpy(q), r, torch.from_numpy(s), dt)
    out = torch.full((len(rows),) + feats.shape[1:], float("nan"), dtype=dt)
    got = gather_rows_packed(*args, out=out)
    assert got is out
    np.testing.assert_array_equal(out.float().numpy(), want)
    with pytest.raises(ValueError, match="out must be"):
        gather_rows_packed(*args, out=out[:-1])
    other = torch.float32 if dt == torch.bfloat16 else torch.bfloat16
    with pytest.raises(ValueError, match="out must be"):
        gather_rows_packed(*args, out=out.to(other))


def test_cpu_dispatch_launches_nothing(rng):
    before = (gather_rows_packed.launches, gather_rows_blocked.launches)
    q, s = quantize_feature_table(_table_with_zero_rows(rng))
    r = torch.tensor([1, 2], dtype=torch.int32)
    gather_rows_packed(torch.from_numpy(q), r, torch.from_numpy(s))
    gather_rows_packed(torch.zeros(4, 2, 8), r)
    gather_rows_blocked(torch.zeros(4, 2, 3), r)
    assert (gather_rows_packed.launches,
            gather_rows_blocked.launches) == before == (0, 0)


def test_wrappers_reject_bad_arguments():
    t = torch.zeros(4, 2, 8)
    with pytest.raises(TypeError, match="int32"):
        gather_rows_packed(t, torch.tensor([1, 2]))            # int64 rows
    with pytest.raises(TypeError, match="int8"):
        gather_rows_packed(t, torch.tensor([1], dtype=torch.int32),
                           torch.ones(4, 2))
    with pytest.raises(TypeError, match="out_dtype"):
        gather_rows_packed(t, torch.tensor([1], dtype=torch.int32),
                           out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="scales"):
        gather_rows_packed(t.to(torch.int8),
                           torch.tensor([1], dtype=torch.int32),
                           torch.ones(4, 3))
