"""The port's GRU encoder (plain scan, and the kernel wrapper on CPU
tensors) against JAX gru_encode and the Pallas scan in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_project_tpu.ops import gru_encode as j_gru_encode
from vqa_project_tpu.ops.pallas import gru_encode_pallas
from vqa_project_tpu_torch.ops import gru_encode, gru_encode_kernel
from vqa_project_tpu_torch.ops.gru import gru_scan_reference
from vqa_project_tpu_torch.ops.gru_scan import gru_scan


def _inputs(rng, b=5, t=9, e=12, h=16):
    emb = rng.normal(size=(b, t, e)).astype(np.float32)
    qlen = np.array([9, 1, 5, 7, 3][:b], dtype=np.int32)
    params = [(rng.normal(size=s) * 0.2).astype(np.float32)
              for s in [(3 * h, e), (3 * h, h), (3 * h,), (3 * h,)]]
    return emb, qlen, params


@pytest.mark.parametrize("port_fn", ["plain", "kernel_wrapper"])
def test_gru_matches_jax(rng, port_fn):
    emb, qlen, params = _inputs(rng)
    jargs = (jnp.asarray(emb), jnp.asarray(qlen), *map(jnp.asarray, params))
    want_scan = np.asarray(j_gru_encode(*jargs, compute_dtype=jnp.float32))
    want_pallas = np.asarray(gru_encode_pallas(
        *jargs, compute_dtype=jnp.float32, interpret=True))
    targs = (torch.from_numpy(emb), torch.from_numpy(qlen),
             *map(torch.from_numpy, params))
    fn = gru_encode if port_fn == "plain" else gru_encode_kernel
    got = fn(*targs, compute_dtype=torch.float32).numpy()
    assert got.dtype == np.float32 and got.shape == want_scan.shape
    np.testing.assert_allclose(got, want_scan, atol=1e-5)
    np.testing.assert_allclose(got, want_pallas, atol=1e-5)


def test_frozen_after_qlen(rng):
    """h at qlen-1 is the answer: steps past qlen leave it untouched."""
    emb, qlen, params = _inputs(rng)
    targs = [torch.from_numpy(p) for p in params]
    full = gru_encode(torch.from_numpy(emb), torch.from_numpy(qlen),
                      *targs)
    noisy = emb.copy()
    for i, n in enumerate(qlen):
        noisy[i, n:] = rng.normal(size=noisy[i, n:].shape)
    again = gru_encode(torch.from_numpy(noisy), torch.from_numpy(qlen),
                       *targs)
    np.testing.assert_array_equal(full.numpy(), again.numpy())


def test_scan_wrapper_on_cpu_is_plain(rng):
    t, b, h = 4, 3, 8
    xp = torch.from_numpy(rng.normal(size=(t, b, 3 * h)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3 * h, h)) * 0.3
                          ).astype(np.float32)).to(torch.bfloat16)
    bias = torch.from_numpy(rng.normal(size=(3 * h,)).astype(np.float32))
    qlen = torch.tensor([4, 1, 2], dtype=torch.int32)
    before = gru_scan.launches
    got = gru_scan(xp, w, bias, qlen)
    np.testing.assert_array_equal(
        got.numpy(), gru_scan_reference(xp, w, bias, qlen).numpy())
    assert gru_scan.launches == before


@pytest.mark.parametrize("case", ["qlen_int64", "xp_bf16", "w_shape",
                                  "h_not_multiple_of_8", "w_strided"])
def test_kernel_input_checks(rng, case):
    """What the CUDA wrapper refuses before a launch (device-independent
    checks, run here on CPU tensors)."""
    from vqa_project_tpu_torch.ops.gru_scan import _check_cuda_inputs

    t, b, h = 3, 2, 16 if case != "h_not_multiple_of_8" else 12
    xp = torch.zeros(t, b, 3 * h)
    w = torch.zeros(3 * h, h, dtype=torch.bfloat16)
    bias = torch.zeros(3 * h)
    qlen = torch.ones(b, dtype=torch.int32)
    if case == "h_not_multiple_of_8":
        with pytest.raises(ValueError, match="H % 8"):
            _check_cuda_inputs(xp, w, bias, qlen)
        return
    assert _check_cuda_inputs(xp, w, bias, qlen) == (t, b, h)
    if case == "qlen_int64":
        qlen = qlen.long()
    elif case == "xp_bf16":
        xp = xp.to(torch.bfloat16)
    elif case == "w_shape":
        w = w[:, :-1]
    else:
        w = torch.zeros(h, 3 * h, dtype=torch.bfloat16).t()
    with pytest.raises((TypeError, ValueError)):
        _check_cuda_inputs(xp, w, bias, qlen)
