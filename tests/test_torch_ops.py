"""Port ops (vqa_project_tpu_torch.ops) against the JAX ops, on CPU.

Inputs are made with numpy from a seed and fed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_project_tpu import ops as jops
from vqa_project_tpu.ops.neighbourhood import \
    masked_neighbourhood as j_masked_neighbourhood
from vqa_project_tpu_torch import ops as tops


def _image(rng, b=3, k=7, f=12):
    feats = rng.normal(size=(b, k, f)).astype(np.float32)
    xy1 = rng.uniform(0, 0.5, size=(b, k, 2))
    wh = rng.uniform(0.05, 0.5, size=(b, k, 2))
    boxes = np.concatenate([xy1, xy1 + wh], -1).astype(np.float32)
    return np.concatenate([feats, boxes], -1)


def test_bbox_centres_and_pseudo_coords(rng):
    image = _image(rng)
    want_c = np.array(jops.bbox_centres(jnp.asarray(image)))
    got_c = tops.bbox_centres(torch.from_numpy(image)).numpy()
    np.testing.assert_allclose(got_c, want_c, rtol=1e-5, atol=1e-6)
    want = np.asarray(jops.polar_pseudo_coords(jnp.asarray(want_c)))
    got = tops.polar_pseudo_coords(torch.from_numpy(want_c)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("precision_scale", [1.0, 1e-3])
def test_gaussian_kernel_weights(rng, precision_scale):
    """Includes tiny precisions, where most kernels underflow and the
    1e-20 denominator clamp decides the result."""
    n = 5
    pseudo = np.stack([rng.uniform(0, 1.5, size=(2, 6, 6)),
                       rng.uniform(-np.pi, np.pi, size=(2, 6, 6))],
                      -1).astype(np.float32)
    params = [rng.uniform(0, 1, n), rng.uniform(-np.pi, np.pi, n),
              rng.uniform(0.1, 1, n) * precision_scale,
              rng.uniform(0.1, 1, n) * precision_scale]
    params = [p.astype(np.float32) for p in params]
    want = np.asarray(jops.gaussian_kernel_weights(
        jnp.asarray(pseudo), *map(jnp.asarray, params)))
    got = tops.gaussian_kernel_weights(
        torch.from_numpy(pseudo), *map(torch.from_numpy, params)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["random", "all_equal", "all_zero",
                                  "ties"])
def test_masked_neighbourhood(rng, kind):
    b, k, m = 3, 10, 4
    if kind == "random":
        adj = rng.normal(size=(b, k, k))
    elif kind == "all_equal":
        adj = np.full((b, k, k), 0.7)
    elif kind == "all_zero":
        adj = np.zeros((b, k, k))
    else:  # few distinct values: many ties at the threshold
        adj = rng.integers(0, 3, size=(b, k, k)).astype(np.float64)
    adj = adj.astype(np.float32)
    alpha_j, mask_j = map(np.asarray, j_masked_neighbourhood(
        jnp.asarray(adj), m))
    alpha_t, mask_t = tops.masked_neighbourhood(torch.from_numpy(adj), m)
    np.testing.assert_array_equal(mask_t.numpy(), mask_j)
    assert (mask_t.sum(-1) == m).all()
    np.testing.assert_allclose(alpha_t.numpy(), alpha_j, atol=1e-6)
