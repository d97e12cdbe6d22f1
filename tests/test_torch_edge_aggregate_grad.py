"""Plain versions of the training kernels C (forward with residuals) and
D (hand-derived VJP) of the edge aggregation, and the autograd Function
that joins them, against the JAX package: its Pallas kernels in
interpret mode and jax.vjp of its XLA reference.

The CUDA kernels themselves are held against these plain versions on
the card by chip_smoke.py (phase 7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_project_tpu.ops.neighbourhood import masked_neighbourhood
from vqa_project_tpu.ops.pallas.edge_aggregate import (
    _pallas_backward, _pallas_forward, edge_aggregate_reference)
from vqa_project_tpu_torch.ops.dropout import philox_keep
from vqa_project_tpu_torch.ops.edge_aggregate import (
    EdgeAggregateFunction, fused_sel_aggregate_act,
    sel_aggregate_act_residuals, sel_aggregate_act_residuals_reference,
    sel_aggregate_act_vjp, sel_aggregate_act_vjp_reference)

N_KERN, D, B = 4, 8, 2
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
# the JAX package's own tolerance for its backward kernel against
# jax.vjp of the reference (tests/test_pallas.py)
BWD_TOL = dict(rtol=2e-3, atol=1e-4)


def _inputs(rng, k, m, use_alpha):
    adj = rng.normal(size=(B, k, k)).astype(np.float32)
    alpha, mask = masked_neighbourhood(jnp.asarray(adj), m)
    sel = np.array(alpha if use_alpha else mask, np.float32)
    pseudo = np.stack(
        [rng.uniform(0, 1.5, size=(B, k, k)),
         rng.uniform(-np.pi, np.pi, size=(B, k, k))], axis=-1
    ).astype(np.float32)
    proj = rng.normal(size=(B, k, N_KERN * D)).astype(np.float32)
    gparams = np.stack([
        rng.uniform(0, 1, N_KERN),
        rng.uniform(-np.pi, np.pi, N_KERN),
        rng.uniform(0.1, 1, N_KERN),
        rng.uniform(0.1, 1, N_KERN),
    ]).astype(np.float32)
    return adj, sel, pseudo, proj, gparams


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("k,m", [(10, 5), (51, 19)])
@pytest.mark.parametrize("relu", [True, False])
def test_residual_forward_matches_pallas(rng, k, m, relu):
    _, sel, pseudo, proj, gparams = _inputs(rng, k, m, True)
    want = [np.asarray(x) for x in _pallas_forward(
        jnp.asarray(sel), jnp.asarray(pseudo), jnp.asarray(proj),
        jnp.asarray(gparams), interpret=True, save_residuals=True,
        relu=relu)]
    args = _t(sel, pseudo, proj, gparams)
    got = sel_aggregate_act_residuals_reference(*args, relu=relu)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, **FWD_TOL)
    before = sel_aggregate_act_residuals.launches
    wrapped = sel_aggregate_act_residuals(*args, relu=relu)
    for g, w in zip(wrapped, got):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert sel_aggregate_act_residuals.launches == before


@pytest.mark.parametrize("k,m,use_alpha,relu", [
    (10, 5, True, True), (10, 5, False, False),
    (51, 19, True, False), (51, 19, False, True)])
def test_plain_vjp_matches_pallas_backward(rng, k, m, use_alpha, relu):
    _, sel, pseudo, proj, gparams = _inputs(rng, k, m, use_alpha)
    out, ghat, denom = _pallas_forward(
        jnp.asarray(sel), jnp.asarray(pseudo), jnp.asarray(proj),
        jnp.asarray(gparams), interpret=True, save_residuals=True,
        relu=relu)
    g = rng.normal(size=proj.shape).astype(np.float32)
    pseudo_cm = jnp.moveaxis(jnp.asarray(pseudo), -1, 1)
    want = _pallas_backward(
        jnp.asarray(g), jnp.asarray(sel), ghat, denom, pseudo_cm,
        jnp.asarray(proj), jnp.asarray(gparams), interpret=True,
        out=out if relu else None)
    tg, tsel, tpseudo, tproj, tgp = _t(g, sel, pseudo, proj, gparams)
    tghat, tdenom, tout = _t(ghat, denom, out)
    got = sel_aggregate_act_vjp_reference(
        tg, tsel, tghat, tdenom, tpseudo, tproj, tgp,
        out=tout if relu else None)
    for name, a, w in zip(("dsel", "dpseudo", "dproj", "dgparams"), got,
                          want):
        w = np.asarray(w)
        assert tuple(a.shape) == w.shape, name
        np.testing.assert_allclose(a.numpy(), w, err_msg=name, **BWD_TOL)


@pytest.mark.parametrize("use_alpha", [True, False])
def test_plain_vjp_matches_jax_vjp_of_reference(rng, use_alpha):
    """Through the softmax selection too: d(adj) from the port's sel
    gradient, carried back by torch autograd, equals jax.vjp of the
    XLA reference end to end."""
    k, m = 12, 5
    adj, _, pseudo, proj, gparams = _inputs(rng, k, m, use_alpha)
    g = rng.normal(size=proj.shape).astype(np.float32)
    def vjp(*args):
        _, pullback = jax.vjp(
            lambda a, p, q, gp: edge_aggregate_reference(
                a, p, q, gp, m=m, use_alpha=use_alpha), *args[:4])
        return pullback(args[4])

    want = [np.asarray(w) for w in jax.jit(vjp)(
        *map(jnp.asarray, (adj, pseudo, proj, gparams, g)))]

    from vqa_project_tpu_torch.ops.neighbourhood import \
        masked_neighbourhood as t_masked

    tadj, tpseudo, tproj, tgp = _t(adj, pseudo, proj, gparams)
    for t in (tadj, tpseudo, tproj, tgp):
        t.requires_grad_(True)
    alpha, mask = t_masked(tadj, m)
    out = EdgeAggregateFunction.apply(alpha if use_alpha else mask, tpseudo,
                                      tproj, tgp, None, False, 0.0)
    out.backward(torch.from_numpy(g))
    for name, t, w in zip(("dadj", "dpseudo", "dproj", "dgparams"),
                          (tadj, tpseudo, tproj, tgp), want):
        # the 0/1 mask is piecewise constant: no graph reaches adj
        got = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_allclose(got.numpy(), w, err_msg=name, **BWD_TOL)


@pytest.mark.parametrize("relu", [True, False])
def test_plain_vjp_matches_torch_autograd(rng, relu):
    """The hand-derived VJP against torch autograd of the plain forward
    (through the Gaussians, the normalization and the relu)."""
    _, sel, pseudo, proj, gparams = _inputs(rng, 10, 5, True)
    args = _t(sel, pseudo, proj, gparams)
    for t in args:
        t.requires_grad_(True)
    out, ghat, denom = sel_aggregate_act_residuals_reference(*args,
                                                             relu=relu)
    g = torch.from_numpy(rng.normal(size=proj.shape).astype(np.float32))
    want = torch.autograd.grad(out, args, g)
    with torch.no_grad():
        got = sel_aggregate_act_vjp_reference(
            g, *[a.detach() for a in (args[0], ghat, denom, args[1],
                                      args[2], args[3])],
            out=out.detach() if relu else None)
    for name, a, w in zip(("dsel", "dpseudo", "dproj", "dgparams"), got,
                          want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), err_msg=name,
                                   **BWD_TOL)


def test_dropout_epilogue_and_its_gradient(rng):
    """Dropout after relu with the Philox mask: kept units are the relu
    output scaled by 1/(1-p), dropped ones 0; the VJP passes gradient
    exactly where out > 0, scaled by 1/(1-p)."""
    rate = 0.5
    _, sel, pseudo, proj, gparams = _inputs(rng, 10, 5, True)
    args = _t(sel, pseudo, proj, gparams)
    seeds = torch.tensor([7, -123456], dtype=torch.int32)
    out, ghat, denom = sel_aggregate_act_residuals_reference(
        *args, relu=True, dropout_rate=rate, seeds=seeds)
    plain = sel_aggregate_act_residuals_reference(*args, relu=True)[0]
    keep = philox_keep(seeds, proj.shape[1:], rate)
    np.testing.assert_array_equal(
        out.numpy(), torch.where(keep, plain * 2.0, 0.0).numpy())
    g = torch.from_numpy(rng.normal(size=proj.shape).astype(np.float32))
    dproj = sel_aggregate_act_vjp_reference(
        g, args[0], ghat, denom, args[1], args[2], args[3], out=out,
        dropout_rate=rate)[2]
    # the same VJP with the mask folded into the cotangent instead
    g_masked = torch.where(out > 0, g * 2.0, 0.0)
    want = sel_aggregate_act_vjp_reference(
        g_masked, args[0], ghat, denom, args[1], args[2], args[3])[2]
    np.testing.assert_array_equal(dproj.numpy(), want.numpy())
    before = sel_aggregate_act_vjp.launches
    wrapped = sel_aggregate_act_vjp(g, args[0], ghat, denom, args[1],
                                    args[2], args[3], out, rate)[2]
    np.testing.assert_array_equal(wrapped.numpy(), dproj.numpy())
    assert sel_aggregate_act_vjp.launches == before


def test_wrapper_takes_the_autograd_path_when_grad_is_wanted(rng):
    _, sel, pseudo, proj, gparams = _inputs(rng, 10, 5, True)
    args = _t(sel, pseudo, proj, gparams)
    args[2].requires_grad_(True)
    out = fused_sel_aggregate_act(*args, relu=True)
    assert out.grad_fn is not None
    out.sum().backward()
    assert args[2].grad is not None and torch.isfinite(args[2].grad).all()
    with torch.no_grad():
        assert fused_sel_aggregate_act(*args, relu=True).grad_fn is None
    with pytest.raises(ValueError, match="seeds"):
        sel_aggregate_act_residuals_reference(*args, relu=True,
                                              dropout_rate=0.5)
