"""Kernel E's persistent reverse sweep, as far as the CPU can check it:
the dispatch rule, the forward's hp that the sweep reads instead of
recomputing (plain versions against JAX), the wrapper's input checks,
the CPU dispatch launching nothing, and GRUScanFunction's gradients
against jax.grad of the Pallas pallas_gru in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vqa_project_tpu_torch.ops.gru_scan as gru_scan_mod
from vqa_project_tpu.ops.pallas.gru_scan import pallas_gru
from vqa_project_tpu_torch.ops.gru import (gru_scan_reference,
                                           gru_scan_sweep_reference)
from vqa_project_tpu_torch.ops.gru_scan import (GRUScanFunction,
                                                _check_sweep_inputs,
                                                gru_scan, gru_scan_bwd,
                                                scan_kernel, sweep_kernel)

BF16 = torch.bfloat16
T, B, H = 6, 5, 64
QLEN = np.array([6, 1, 3, 0, 2], np.int32)


def _inputs(rng, scale=0.15):
    xp = rng.normal(size=(T, B, 3 * H)).astype(np.float32)
    w = (rng.normal(size=(3 * H, H)) * scale).astype(np.float32)
    b = (rng.normal(size=(3 * H,)) * scale).astype(np.float32)
    gh = rng.normal(size=(B, H)).astype(np.float32)
    return xp, w, b, gh


def _torch_args(xp, w, b, dtype):
    return [torch.from_numpy(xp), torch.from_numpy(w).to(dtype),
            torch.from_numpy(b), torch.from_numpy(QLEN)]


@pytest.mark.parametrize("b", [1, 2, 8, 15, 16, 17, 32, 33, 50, 64, 128,
                               129, 150, 200, 255, 256])
def test_persistent_sweep_takes_every_model_batch(b):
    """At the model's width in bf16, every batch from 1 to 256 runs the
    one-launch persistent sweep."""
    assert sweep_kernel(BF16, b, 1024) == "persistent"


@pytest.mark.parametrize("dtype,b,h", [
    (torch.float32, 16, 1024),   # f32 weights stay exact on SIMT cores
    (torch.float32, 64, 1024),
    (BF16, 257, 1024),           # batch past the kernel's 16 tiles
    (BF16, 16, 1032),            # H not a multiple of 64
    (BF16, 16, 2048),            # more units than the grid can hold
    (BF16, 16, 8),
])
def test_per_step_sweep_takes_the_rest(dtype, b, h):
    assert sweep_kernel(dtype, b, h) == "per_step"


@pytest.mark.parametrize("dtype,b,h", [
    (BF16, 1, 1024), (BF16, 256, 1024), (BF16, 257, 1024), (BF16, 64, 64),
    (BF16, 64, 1088), (BF16, 64, 1032), (torch.float32, 64, 1024)])
def test_sweep_rule_follows_the_forward(dtype, b, h):
    """The persistent sweep reads the hp that only kernel B's persistent
    kernel writes: the two rules pick the same shapes."""
    assert ((sweep_kernel(dtype, b, h) == "persistent")
            == (scan_kernel(dtype, b, h) == "persistent"))


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_plain_hp_matches_jax_product(rng, dtype):
    """The plain forward's hp is h_prev in the weight dtype times W^T
    plus b_hh, summed in f32: JAX's jnp.dot with preferred_element_type
    on the same states gives it within f32 rounding."""
    xp, w, b, _ = _inputs(rng)
    args = _torch_args(xp, w, b, dtype)
    final, hs, hp = gru_scan_reference(*args, return_hs=True, return_hp=True)
    assert hp.shape == (T, B, 3 * H) and hp.dtype == torch.float32
    assert torch.equal(final, hs[-1])
    h_prev = np.concatenate([np.zeros((1, B, H), np.float32),
                             hs[:-1].numpy()])
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    want = jnp.dot(jnp.asarray(h_prev).astype(jdt),
                   jnp.asarray(w.T).astype(jdt),
                   preferred_element_type=jnp.float32) + jnp.asarray(b)
    np.testing.assert_allclose(hp.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_plain_sweep_fed_hp_equals_the_recomputing_sweep(rng, dtype):
    """Given the forward's own hp, the plain sweep gives the recomputing
    sweep's dxp and dhp bit for bit: the same product, summed the same
    way."""
    xp, w, b, gh = _inputs(rng)
    args = _torch_args(xp, w, b, dtype)
    _, hs, hp = gru_scan_reference(*args, return_hs=True, return_hp=True)
    g = torch.from_numpy(gh)
    dxp, dhp = gru_scan_sweep_reference(*args, hs, g, hp)
    want_dxp, want_dhp = gru_scan_sweep_reference(*args, hs, g)
    assert dhp.dtype == dtype
    assert torch.equal(dxp, want_dxp) and torch.equal(dhp, want_dhp)


def test_cpu_dispatch_launches_nothing(rng):
    """On CPU tensors the wrappers are the plain versions, hp and all,
    and no launch is counted."""
    xp, w, b, gh = _inputs(rng)
    args = _torch_args(xp, w, b, BF16)
    before = (gru_scan.launches, gru_scan_bwd.launches)
    final, hs, hs16, hp = gru_scan(*args, return_hs=True, return_hp=True)
    _, want_hs, want_hp = gru_scan_reference(*args, True, True)
    assert torch.equal(hs, want_hs) and torch.equal(hp, want_hp)
    assert torch.equal(hs16, hs.to(BF16)) and torch.equal(final, hs[-1])
    dxp, dhp = gru_scan_bwd(*args, hs, torch.from_numpy(gh), hp)
    want = gru_scan_sweep_reference(*args, hs, torch.from_numpy(gh))
    assert torch.equal(dxp, want[0]) and torch.equal(dhp, want[1])
    assert (gru_scan.launches, gru_scan_bwd.launches) == before


def test_return_hp_needs_return_hs(rng):
    xp, w, b, _ = _inputs(rng)
    args = _torch_args(xp, w, b, BF16)
    with pytest.raises(ValueError, match="return_hs"):
        gru_scan(*args, return_hp=True)
    with pytest.raises(ValueError, match="return_hs"):
        gru_scan_reference(*args, return_hp=True)


@pytest.mark.parametrize("case", ["no_hp", "hp_per_step", "hp_shape",
                                  "hp_dtype", "hp_strided", "hs_dtype",
                                  "gh_shape"])
def test_sweep_input_checks(case):
    """What the CUDA wrapper refuses before a launch (device-independent
    checks, run here on CPU tensors)."""
    t, b, h = 3, 2, 64
    xp = torch.zeros(t, b, 3 * h)
    w = torch.zeros(3 * h, h, dtype=BF16)
    bias = torch.zeros(3 * h)
    qlen = torch.ones(b, dtype=torch.int32)
    hs = torch.zeros(t, b, h)
    gh = torch.zeros(b, h)
    hp = torch.zeros(t, b, 3 * h)
    assert _check_sweep_inputs(xp, w, bias, qlen, hs, gh, hp) == (
        t, b, h, "persistent")
    assert _check_sweep_inputs(xp, w.float(), bias, qlen, hs, gh, None) == (
        t, b, h, "per_step")
    err = ValueError
    if case == "no_hp":
        hp = None
    elif case == "hp_per_step":
        w = w.float()
    elif case == "hp_shape":
        hp = hp[:, :, :h]
    elif case == "hp_dtype":
        hp, err = hp.to(BF16), TypeError
    elif case == "hp_strided":
        hp = torch.zeros(t, 3 * h, b).transpose(1, 2)
    elif case == "hs_dtype":
        hs, err = hs.double(), TypeError
    else:
        gh = gh[:1]
    with pytest.raises(err):
        _check_sweep_inputs(xp, w, bias, qlen, hs, gh, hp)


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_gru_function_grads_match_pallas_gru(rng, monkeypatch, dtype):
    """GRUScanFunction against jax.grad of pallas_gru (interpret mode) on
    the same weights. In bf16 the backward's sweep is handed the
    forward's hp, as the persistent sweep takes it; in f32 it recomputes
    hp, as the per-step sweep does. Both sides round h_prev and dhp to
    the weight dtype at the same points and sum in f32, in another
    order: in bf16 a rounding of dhp can land one unit apart, so dxp is
    held to 1e-3 relative and dW, stored in bf16, to 2^-7 relative; in
    f32 everything to 1e-4."""
    handed = []

    def spy(*a):
        handed.append(a[6] is not None if len(a) > 6 else False)
        return gru_scan_sweep_reference(*a)

    monkeypatch.setattr(gru_scan_mod, "gru_scan_sweep_reference", spy)
    xp, w, b, gh = _inputs(rng)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    wj = jnp.asarray(w.T).astype(jdt)

    def loss(xp_, w_t_, b_):
        h = pallas_gru(xp_, w_t_, b_, jnp.asarray(QLEN), True)
        return jnp.sum(h * jnp.asarray(gh))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(xp), wj,
                                             jnp.asarray(b))
    txp = torch.from_numpy(xp).requires_grad_(True)
    tw = torch.from_numpy(w).to(dtype).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    h = GRUScanFunction.apply(txp, tw, tb, torch.from_numpy(QLEN))
    (h * torch.from_numpy(gh)).sum().backward()
    assert handed == [dtype == BF16]
    assert tw.grad.dtype == dtype
    tol = 1e-3 if dtype == BF16 else 1e-4
    np.testing.assert_allclose(txp.grad.numpy(), np.asarray(want[0]),
                               rtol=tol, atol=1e-5)
    dw_want = np.asarray(want[1].astype(jnp.float32)).T
    np.testing.assert_allclose(tw.grad.float().numpy(), dw_want,
                               rtol=2 ** -7 if dtype == BF16 else 1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want[2]),
                               rtol=tol, atol=1e-5)
