"""Kernel B's persistent launch and kernel E's wgmma weight gradient, as
far as the CPU can check them: the dispatch rules, the bf16 states hs16
that the forward keeps for the weight gradient (plain versions, and
GRUScanFunction against jax.grad of the Pallas pallas_gru in interpret
mode), the wrappers' input checks, and the CPU dispatch launching
nothing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_project_tpu.ops.pallas.gru_scan import pallas_gru
from vqa_project_tpu_torch.ops.gru import (gru_scan_bwd_reference,
                                           gru_scan_reference,
                                           gru_scan_sweep_reference,
                                           gru_wgrad_reference)
from vqa_project_tpu_torch.ops.gru_scan import (GRUScanFunction,
                                                _check_wgrad_inputs,
                                                gru_scan, gru_scan_bwd,
                                                gru_wgrad, scan_kernel,
                                                wgrad_kernel)

BF16 = torch.bfloat16
# H = 64 is the narrowest width the wgmma weight gradient takes, so the
# bf16 path below hands it hs16, as the model does at H = 1024
T, B, H = 6, 5, 64
QLEN = np.array([6, 1, 3, 0, 2], np.int32)


def _inputs(rng, scale=0.15):
    xp = rng.normal(size=(T, B, 3 * H)).astype(np.float32)
    w = (rng.normal(size=(3 * H, H)) * scale).astype(np.float32)
    b = (rng.normal(size=(3 * H,)) * scale).astype(np.float32)
    gh = rng.normal(size=(B, H)).astype(np.float32)
    return xp, w, b, gh


@pytest.mark.parametrize("b", [1, 2, 15, 16, 17, 50, 64, 128, 200, 255,
                               256])
def test_persistent_rule_takes_every_model_batch(b):
    """At the model's width in bf16, every batch from 1 to 256 runs the
    one-launch persistent kernel."""
    assert scan_kernel(BF16, b, 1024) == "persistent"


@pytest.mark.parametrize("dtype,b,h", [
    (torch.float32, 16, 1024),   # f32 weights stay exact on SIMT cores
    (torch.float32, 64, 1024),
    (BF16, 257, 1024),           # batch past the kernel's 16 tiles
    (BF16, 4096, 1024),
    (BF16, 16, 1032),            # H not a multiple of 64
    (BF16, 16, 2048),            # 256 blocks: more than one wave
    (BF16, 16, 8),
])
def test_per_step_rule_takes_the_rest(dtype, b, h):
    assert scan_kernel(dtype, b, h) == "per_step"


@pytest.mark.parametrize("dtype,h,want", [
    (BF16, 1024, "wgmma"), (BF16, 64, "wgmma"), (BF16, 1000, "simt"),
    (BF16, 8, "simt"), (torch.float32, 1024, "simt"),
    (torch.float32, 64, "simt")])
def test_wgrad_rule(dtype, h, want):
    assert wgrad_kernel(dtype, h) == want


@pytest.mark.parametrize("t,b,h", [(6, 5, 64), (1, 3, 16), (4, 50, 8)])
def test_plain_wgrad_same_from_hs_and_hs16(rng, t, b, h):
    """The weight gradient's plain version gives the same dW and db, bit
    for bit, from the f32 states and from their bf16 rounding: the
    product rounds h_prev to bf16 either way."""
    dhp = torch.from_numpy(rng.normal(size=(t, b, 3 * h)).astype(
        np.float32)).to(BF16)
    hs = torch.from_numpy(rng.normal(size=(t, b, h)).astype(np.float32))
    dw, db = gru_wgrad_reference(dhp, hs)
    dw16, db16 = gru_wgrad_reference(dhp, hs.to(BF16))
    assert dw.dtype == dw16.dtype == torch.float32
    assert torch.equal(dw, dw16) and torch.equal(db, db16)


def test_cpu_scan_returns_hs16_and_launches_nothing(rng):
    xp, w, b, _ = _inputs(rng)
    args = [torch.from_numpy(xp), torch.from_numpy(w).to(BF16),
            torch.from_numpy(b), torch.from_numpy(QLEN)]
    before = gru_scan.launches
    final, hs, hs16 = gru_scan(*args, return_hs=True)
    want_final, want_hs = gru_scan_reference(*args, return_hs=True)
    assert torch.equal(final, want_final) and torch.equal(hs, want_hs)
    assert hs16.dtype == BF16 and torch.equal(hs16, hs.to(BF16))
    assert torch.equal(gru_scan(*args), want_final)
    assert gru_scan.launches == before


def test_cpu_wgrad_takes_hs16_and_launches_nothing(rng):
    xp, w, b, gh = _inputs(rng)
    args = [torch.from_numpy(xp), torch.from_numpy(w).to(BF16),
            torch.from_numpy(b), torch.from_numpy(QLEN)]
    _, hs, hs16 = gru_scan(*args, return_hs=True)
    _, dhp = gru_scan_bwd(*args, hs, torch.from_numpy(gh))
    before = gru_wgrad.launches
    dw, db = gru_wgrad(dhp, hs16)
    want = gru_wgrad_reference(dhp, hs)
    assert torch.equal(dw, want[0]) and torch.equal(db, want[1])
    assert gru_wgrad.launches == before


@pytest.mark.parametrize("case", ["wgmma_f32_states", "simt_bf16_states",
                                  "shape", "width",
                                  "strided", "int_dhp", "dhp_2d"])
def test_wgrad_input_checks(case):
    """What the CUDA wrapper refuses before a launch (device-independent
    checks, run here on CPU tensors)."""
    t, b, h = 3, 2, 64
    dhp = torch.zeros(t, b, 3 * h, dtype=BF16)
    hs16 = torch.zeros(t, b, h, dtype=BF16)
    assert _check_wgrad_inputs(dhp, hs16) == "wgmma"
    assert _check_wgrad_inputs(dhp.float(), hs16.float()) == "simt"
    err = ValueError
    if case == "wgmma_f32_states":
        hs16, err = hs16.float(), TypeError
    elif case == "simt_bf16_states":
        dhp, err = dhp.float(), TypeError
    elif case == "shape":
        hs16 = hs16[:-1]
    elif case == "width":
        hs16 = torch.zeros(t, b, h + 1, dtype=BF16)
    elif case == "strided":
        hs16 = torch.zeros(t, h, b, dtype=BF16).transpose(1, 2)
    elif case == "int_dhp":
        dhp, err = dhp.to(torch.int16), TypeError
    else:
        dhp = dhp[0]
    with pytest.raises(err):
        _check_wgrad_inputs(dhp, hs16)


def test_gru_function_bf16_grads_match_pallas_gru(rng):
    """GRUScanFunction with bf16 weights, its weight gradient taken from
    hs16, against jax.grad of pallas_gru (interpret mode) on the same
    bf16 weights. Both round h_prev and dhp to bf16 at the same points
    and sum in f32; the sums run in another order, so a bf16 rounding of
    dhp can land one unit apart: dxp is held to 1e-3 relative, and dW,
    stored in bf16, to 2^-7 relative (one to two bf16 units)."""
    xp, w, b, gh = _inputs(rng)
    w16 = jnp.asarray(w.T).astype(jnp.bfloat16)

    def loss(xp_, w_t_, b_):
        h = pallas_gru(xp_, w_t_, b_, jnp.asarray(QLEN), True)
        return jnp.sum(h * jnp.asarray(gh))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(xp), w16,
                                             jnp.asarray(b))
    txp = torch.from_numpy(xp).requires_grad_(True)
    tw = torch.from_numpy(w).to(BF16).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    h = GRUScanFunction.apply(txp, tw, tb, torch.from_numpy(QLEN))
    (h * torch.from_numpy(gh)).sum().backward()
    assert tw.grad.dtype == BF16
    np.testing.assert_allclose(txp.grad.numpy(), np.asarray(want[0]),
                               rtol=1e-3, atol=1e-5)
    dw_want = np.asarray(want[1].astype(jnp.float32)).T
    np.testing.assert_allclose(tw.grad.float().numpy(), dw_want,
                               rtol=2 ** -7, atol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want[2]),
                               rtol=1e-3, atol=1e-5)


def test_gru_function_bf16_weight_grad_is_the_plain_one(rng):
    """Through the hs16 plumbing, GRUScanFunction's weight gradient is
    the plain backward's, bit for bit."""
    xp, w, b, gh = _inputs(rng)
    txp = torch.from_numpy(xp)
    tw = torch.from_numpy(w).to(BF16).requires_grad_(True)
    tb = torch.from_numpy(b)
    q = torch.from_numpy(QLEN)
    GRUScanFunction.apply(txp, tw, tb, q).backward(torch.from_numpy(gh))
    _, hs = gru_scan_reference(txp, tw.detach(), tb, q, return_hs=True)
    _, dw, _ = gru_scan_bwd_reference(txp, tw.detach(), tb, q, hs,
                                      torch.from_numpy(gh))
    assert torch.equal(tw.grad, dw.to(BF16))
    dxp, _ = gru_scan_sweep_reference(txp, tw.detach(), tb, q, hs,
                                      torch.from_numpy(gh))
    assert not dxp[:, 3].any()  # qlen 0: the row never updates
