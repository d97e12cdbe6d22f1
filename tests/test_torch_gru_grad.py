"""Plain versions of the GRU backward kernels (E: reverse sweep and
weight gradient), the states kernel B now keeps, and GRUScanFunction,
against the JAX package: _bwd_xla_reference, the Pallas backward in
interpret mode, and jax.grad of gru_encode_pallas."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_project_tpu.ops.pallas.gru_scan import (_bwd_xla_reference,
                                                 _pallas_backward,
                                                 _pallas_forward,
                                                 gru_encode_pallas)
from vqa_project_tpu_torch.ops.gru import (gru_scan_bwd_reference,
                                           gru_scan_reference,
                                           gru_scan_sweep_reference,
                                           gru_wgrad_reference)
from vqa_project_tpu_torch.ops.gru_scan import (GRUScanFunction,
                                                gru_encode_kernel, gru_scan,
                                                gru_scan_bwd, gru_wgrad)

TOL = dict(rtol=1e-4, atol=1e-6)
T, B, H = 6, 5, 8
QLEN = np.array([6, 1, 3, 5, 2], np.int32)


def _scan_inputs(rng, scale=0.3):
    xp = rng.normal(size=(T, B, 3 * H)).astype(np.float32)
    w = (rng.normal(size=(3 * H, H)) * scale).astype(np.float32)
    b = (rng.normal(size=(3 * H,)) * scale).astype(np.float32)
    gh = rng.normal(size=(B, H)).astype(np.float32)
    return xp, w, b, gh


def test_states_match_pallas_forward(rng):
    xp, w, b, _ = _scan_inputs(rng)
    h_want, hs_want = _pallas_forward(jnp.asarray(xp), jnp.asarray(w.T),
                                      jnp.asarray(b), jnp.asarray(QLEN),
                                      True)
    args = [torch.from_numpy(a) for a in (xp, w, b, QLEN)]
    h, hs = gru_scan_reference(*args, return_hs=True)
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_want), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), **TOL)
    before = gru_scan.launches
    h2, hs2, hs16 = gru_scan(*args, return_hs=True)
    np.testing.assert_array_equal(hs2.numpy(), hs.numpy())
    assert hs16 is None  # f32 weights: no bf16 copy of the states
    assert gru_scan.launches == before


@pytest.mark.parametrize("oracle", ["xla_reference", "pallas_interpret"])
def test_plain_reverse_sweep_matches_jax(rng, oracle):
    xp, w, b, gh = _scan_inputs(rng)
    _, hs = _pallas_forward(jnp.asarray(xp), jnp.asarray(w.T),
                            jnp.asarray(b), jnp.asarray(QLEN), True)
    jargs = (jnp.asarray(xp), jnp.asarray(w.T), jnp.asarray(b),
             jnp.asarray(QLEN))
    if oracle == "xla_reference":
        dxp_w, dwt_w, db_w, _ = _bwd_xla_reference((*jargs, hs),
                                                   jnp.asarray(gh))
    else:
        dxp_w, dwt_w, db_w = _pallas_backward(*jargs, hs, jnp.asarray(gh),
                                              True)
    targs = [torch.from_numpy(a) for a in (xp, w, b, QLEN)]
    ths = torch.from_numpy(np.array(hs))
    dxp, dw, db = gru_scan_bwd_reference(*targs, ths, torch.from_numpy(gh))
    np.testing.assert_allclose(dxp.numpy(), np.asarray(dxp_w), **TOL)
    # the JAX weight gradient is for W^T (H, 3H)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dwt_w).T, **TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_w), **TOL)


def test_wrappers_on_cpu_are_the_plain_pieces(rng):
    """The step-kernel and weight-gradient wrappers take the plain
    sweep and reduction on CPU tensors, and launch nothing."""
    xp, w, b, gh = _scan_inputs(rng)
    targs = [torch.from_numpy(a) for a in (xp, w, b, QLEN)]
    targs[1] = targs[1].to(torch.bfloat16)
    _, hs = gru_scan_reference(*targs, return_hs=True)
    before = (gru_scan_bwd.launches, gru_wgrad.launches)
    dxp, dhp = gru_scan_bwd(*targs, hs, torch.from_numpy(gh))
    assert dxp.dtype == torch.float32 and dhp.dtype == torch.bfloat16
    want_dxp, want_dhp = gru_scan_sweep_reference(*targs, hs,
                                                  torch.from_numpy(gh))
    np.testing.assert_array_equal(dxp.numpy(), want_dxp.numpy())
    dw, db = gru_wgrad(dhp, hs)
    want = gru_wgrad_reference(want_dhp, hs)
    np.testing.assert_array_equal(dw.numpy(), want[0].numpy())
    np.testing.assert_array_equal(db.numpy(), want[1].numpy())
    assert (gru_scan_bwd.launches, gru_wgrad.launches) == before


def test_frozen_rows_pass_the_gradient_through(rng):
    """Past a row's qlen the state is frozen, so dh passes unchanged to
    the earlier steps and those steps' dxp is 0."""
    xp, w, b, gh = _scan_inputs(rng)
    targs = [torch.from_numpy(a) for a in (xp, w, b, QLEN)]
    _, hs = gru_scan_reference(*targs, return_hs=True)
    dxp, _ = gru_scan_sweep_reference(*targs, hs, torch.from_numpy(gh))
    for row, n in enumerate(QLEN):
        assert not dxp[n:, row].any()
        assert dxp[n - 1, row].abs().sum() > 0


@pytest.mark.parametrize("pallas_bwd", [False, True])
def test_gru_function_grads_match_jax_grad(rng, monkeypatch, pallas_bwd):
    """GRUScanFunction, inside gru_encode_kernel, against jax.grad of
    gru_encode_pallas (interpret mode) with its default backward and
    with its Pallas backward."""
    if pallas_bwd:
        monkeypatch.setenv("VQAX_PALLAS_GRU_BWD", "1")
    e = 7
    emb = rng.normal(size=(B, T, e)).astype(np.float32)
    params = [(rng.normal(size=s) * 0.3).astype(np.float32)
              for s in [(3 * H, e), (3 * H, H), (3 * H,), (3 * H,)]]
    cot = rng.normal(size=(B, H)).astype(np.float32)

    def loss(emb_, w_ih, w_hh, b_ih, b_hh):
        h = gru_encode_pallas(emb_, jnp.asarray(QLEN), w_ih, w_hh, b_ih,
                              b_hh, compute_dtype=jnp.float32,
                              interpret=True)
        return jnp.sum(h * cot)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(emb), *map(jnp.asarray, params))
    targs = [torch.from_numpy(a).requires_grad_(True)
             for a in (emb, *params)]
    h = gru_encode_kernel(targs[0], torch.from_numpy(QLEN), *targs[1:],
                          compute_dtype=torch.float32)
    assert h.grad_fn is not None
    (h * torch.from_numpy(cot)).sum().backward()
    for name, t, w in zip(("emb", "w_ih", "w_hh", "b_ih", "b_hh"), targs,
                          want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=name, rtol=1e-4, atol=1e-5)


def test_gru_function_bf16_weight_grad_keeps_its_dtype(rng):
    xp, w, b, gh = _scan_inputs(rng)
    txp = torch.from_numpy(xp).requires_grad_(True)
    tw = torch.from_numpy(w).to(torch.bfloat16).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    h = GRUScanFunction.apply(txp, tw, tb, torch.from_numpy(QLEN))
    h.backward(torch.from_numpy(gh))
    assert tw.grad.dtype == torch.bfloat16 and tb.grad.dtype == torch.float32
    assert txp.grad.dtype == torch.float32
    _, hs = gru_scan_reference(txp.detach(), tw.detach(), tb.detach(),
                               torch.from_numpy(QLEN), return_hs=True)
    _, dw, _ = gru_scan_bwd_reference(txp.detach(), tw.detach(), tb.detach(),
                                      torch.from_numpy(QLEN), hs,
                                      torch.from_numpy(gh))
    np.testing.assert_array_equal(tw.grad.float().numpy(),
                                  dw.to(torch.bfloat16).float().numpy())
