"""The bf16 tensor-core bodies of kernels A, C and D (csrc/
edge_aggregate.cu, edge_aggregate_bwd.cu): their dispatch rule, a plain
torch model of their arithmetic against the JAX package's
fused_sel_aggregate_act and its VJP (Pallas in interpret mode), and the
wrappers' CPU dispatch at the shapes the rule sends to them.

The model follows the kernels step by step: each Gaussian as one exp of
exponent scales computed once per kernel, w = sel * ghat split into
hi = bf16(w) and lo = bf16(w - hi), bf16 operands, f32 sums of hi P and
lo P; in the backward g masked by out > 0 in bf16 (exact) and 1/(1-rate)
applied to the f32 sums. The kernels themselves are held against the
port's plain versions on the card by chip_smoke.py (phases 3 and 7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_project_tpu.ops.neighbourhood import masked_neighbourhood
from vqa_project_tpu.ops.pallas.edge_aggregate import (_pallas_backward,
                                                       _pallas_forward)
from vqa_project_tpu_torch.ops.dropout import philox_keep
from vqa_project_tpu_torch.ops.edge_aggregate import (
    aggregate_kernel, fused_sel_aggregate_act, sel_aggregate_act_reference,
    sel_aggregate_act_residuals, sel_aggregate_act_residuals_reference,
    sel_aggregate_act_vjp, sel_aggregate_act_vjp_reference)

N_KERN, D, B = 4, 16, 2
# hi + lo carries each weight to within 2^-16 of itself (lo's own
# rounding, 2^-8 of |w - hi| <= 2^-8 |w|), so an output moves by at most
# 2^-16 sum_j |w_ij p_j|; normalized by the largest output that is a few
# times 2^-16, and 2^-14 leaves room for the f32 sums' order. One bf16
# pass (hi alone) misses by ~2^-9 and fails it.
SPLIT_TOL = 2.0 ** -14
# the JAX package's own tolerance for its backward kernel against
# jax.vjp of the reference (tests/test_pallas.py): dsel, dpseudo and
# dgparams differ from it only by the f32 sums' order
BWD_TOL = dict(rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("dtype,k,n,d,want", [
    (torch.bfloat16, 36, 8, 256, "mma"),     # VQA conv1
    (torch.bfloat16, 36, 8, 128, "mma"),     # VQA conv2
    (torch.bfloat16, 51, 8, 256, "mma"),     # medical, rows padded to 64
    (torch.bfloat16, 64, 1, 40, "mma"),      # 80-byte rows
    (torch.bfloat16, 1, 1, 8, "mma"),
    (torch.bfloat16, 65, 8, 256, "simt"),    # past 64 rows
    (torch.bfloat16, 36, 8, 36, "simt"),     # 72-byte rows
    (torch.float32, 36, 8, 256, "simt"),     # f32 keeps exact f32 sums
    (torch.float16, 36, 8, 256, "simt"),
])
def test_aggregate_kernel_rule(dtype, k, n, d, want):
    assert aggregate_kernel(dtype, k, n, d) == want


def _inputs(rng, k, m):
    adj = rng.normal(size=(B, k, k)).astype(np.float32)
    alpha, _ = masked_neighbourhood(jnp.asarray(adj), m)
    sel = np.array(alpha, np.float32)
    pseudo = np.stack(
        [rng.uniform(0, 1.5, size=(B, k, k)),
         rng.uniform(-np.pi, np.pi, size=(B, k, k))], axis=-1
    ).astype(np.float32)
    # bf16 values, held as f32 for JAX (whose f32 product is then exact
    # on the same operands)
    proj = torch.from_numpy(rng.normal(size=(B, k, N_KERN * D)).astype(
        np.float32)).to(torch.bfloat16).float().numpy()
    gparams = np.stack([
        rng.uniform(0, 1, N_KERN),
        rng.uniform(-np.pi, np.pi, N_KERN),
        rng.uniform(0.1, 1, N_KERN),
        rng.uniform(0.1, 1, N_KERN),
    ]).astype(np.float32)
    return sel, pseudo, proj, gparams


def _split(w):
    hi = w.to(torch.bfloat16)
    return hi, (w - hi.float()).to(torch.bfloat16)


def _weights(sel, ghat, passes=2):
    """sel * ghat as the bodies multiply it: hi, then lo, each bf16."""
    hi, lo = _split(sel[:, None] * ghat)
    return [hi, lo][:passes]


def mma_gaussians(pseudo, gparams):
    """ghat (B, n, K, K) and denom (B, K, K) as the mma body evaluates
    them: exp(dr^2 c_r + dt^2 c_t) with c = -0.5 / (1e-14 + prec^2) per
    kernel, NaN as 0, the denominator clamped at 1e-20."""
    mu_r, mu_t, pr, pt = (gparams[i].reshape(1, -1, 1, 1) for i in range(4))
    c_r = -0.5 / (1e-14 + pr * pr)
    c_t = -0.5 / (1e-14 + pt * pt)
    rho, theta = pseudo[..., 0][:, None], pseudo[..., 1][:, None]
    first = torch.abs(theta - mu_t)
    dt = torch.minimum(first, torch.abs(2 * np.float32(np.pi) - first))
    w = torch.exp((rho - mu_r) ** 2 * c_r + dt * dt * c_t)
    w = torch.nan_to_num(w, nan=0.0)
    denom = torch.clamp(w.sum(dim=1), min=1e-20)
    return w / denom[:, None], denom


def mma_forward_model(sel, pseudo, proj16, gparams, rate, seeds, passes=2):
    """Kernel C's mma body: (out f32 before its bf16 store, ghat,
    denom)."""
    b, k, nd = proj16.shape
    ghat, denom = mma_gaussians(pseudo, gparams)
    p4 = proj16.float().reshape(b, k, N_KERN, nd // N_KERN)
    acc = sum(torch.einsum("bnij,bjnd->bind", w.float(), p4)
              for w in _weights(sel, ghat, passes)).reshape(b, k, nd)
    acc = torch.relu(acc)
    if rate > 0:
        keep = philox_keep(seeds, acc.shape[1:], rate)
        acc = torch.where(keep, acc * (1.0 / (1.0 - rate)), 0.0)
    return acc, ghat, denom


def mma_vjp_model(g16, sel, ghat, denom, pseudo, proj16, gparams, out16,
                  rate):
    """Kernel D's mma body: g masked in bf16, the products from exact
    bf16 operands in f32, 1/(1-rate) on the sums. The edge chain after
    G_n is linear in G_n, so it runs on the masked g and is scaled
    after. dproj is returned in f32, before its bf16 store."""
    b, k, nd = proj16.shape
    inv_keep = 1.0 / (1.0 - rate) if rate > 0 else 1.0
    gm = torch.where(out16 > 0, g16, torch.zeros_like(g16))
    g4 = gm.float().reshape(b, k, N_KERN, nd // N_KERN)
    dproj = sum(torch.einsum("bnij,bind->bjnd", w.float(), g4)
                for w in _weights(sel, ghat)).reshape(b, k, nd) * inv_keep
    dsel, dpseudo, _, dgp = sel_aggregate_act_vjp_reference(
        gm.float(), sel, ghat, denom, pseudo, proj16.float(), gparams)
    return dsel * inv_keep, dpseudo * inv_keep, dproj, dgp * inv_keep


def _norm_err(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    return float(np.abs(np.asarray(got) - want).max()) / scale


@pytest.mark.parametrize("k,m", [(10, 5), (51, 19)])
@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_mma_model_matches_jax(rng, k, m, rate):
    sel, pseudo, proj, gparams = _inputs(rng, k, m)
    assert aggregate_kernel(torch.bfloat16, k, N_KERN, D) == "mma"
    j_out, j_ghat, j_denom = _pallas_forward(
        jnp.asarray(sel), jnp.asarray(pseudo), jnp.asarray(proj),
        jnp.asarray(gparams), interpret=True, save_residuals=True,
        relu=True)
    t_sel, t_pseudo, t_proj, t_gp = (torch.from_numpy(a) for a in
                                     (sel, pseudo, proj, gparams))
    proj16 = t_proj.to(torch.bfloat16)
    seeds = torch.tensor([11, -40000], dtype=torch.int32)
    # JAX draws its dropout bits from the TPU's PRNG: its relu output
    # under the port's Philox mask is the function the kernels compute
    want = torch.from_numpy(np.array(j_out))
    if rate > 0:
        keep = philox_keep(seeds, want.shape[1:], rate)
        want = torch.where(keep, want * (1.0 / (1.0 - rate)), 0.0)
    out, ghat, denom = mma_forward_model(t_sel, t_pseudo, proj16, t_gp,
                                         rate, seeds)
    assert _norm_err(out, want) <= SPLIT_TOL
    np.testing.assert_allclose(ghat.numpy(), np.asarray(j_ghat),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(denom.numpy(), np.asarray(j_denom),
                               rtol=1e-4, atol=1e-5)
    one_pass = mma_forward_model(t_sel, t_pseudo, proj16, t_gp, rate,
                                 seeds, passes=1)[0]
    assert _norm_err(one_pass, want) > SPLIT_TOL

    out16 = out.to(torch.bfloat16)
    g16 = torch.from_numpy(rng.normal(size=proj.shape).astype(
        np.float32)).to(torch.bfloat16)
    want_g = _pallas_backward(
        jnp.asarray(g16.float().numpy()), jnp.asarray(sel), j_ghat, j_denom,
        jnp.moveaxis(jnp.asarray(pseudo), -1, 1), jnp.asarray(proj),
        jnp.asarray(gparams), interpret=True,
        out=jnp.asarray(out16.float().numpy()), dropout_rate=rate)
    got = mma_vjp_model(g16, t_sel, ghat, denom, t_pseudo, proj16, t_gp,
                        out16, rate)
    for name, a, w in zip(("dsel", "dpseudo", "dproj", "dgparams"), got,
                          want_g):
        w = np.asarray(w)
        assert tuple(a.shape) == w.shape, name
        if name == "dproj":
            assert _norm_err(a, w) <= SPLIT_TOL, name
        else:
            np.testing.assert_allclose(a.numpy(), w, err_msg=name, **BWD_TOL)


@pytest.mark.parametrize("k,m", [(10, 5), (51, 19)])
def test_cpu_dispatch_at_mma_shapes_takes_plain_versions(rng, k, m):
    """bf16 CPU tensors at shapes the rule sends to the mma bodies: every
    wrapper returns its plain version's bits and launches nothing."""
    sel, pseudo, proj, gparams = (torch.from_numpy(a)
                                  for a in _inputs(rng, k, m))
    proj = proj.to(torch.bfloat16)
    assert aggregate_kernel(proj.dtype, k, N_KERN, D) == "mma"
    seeds = torch.tensor([3, 4], dtype=torch.int32)
    counters = (fused_sel_aggregate_act, sel_aggregate_act_residuals,
                sel_aggregate_act_vjp)
    before = [f.launches for f in counters]
    out = fused_sel_aggregate_act(sel, pseudo, proj, gparams, relu=True)
    assert torch.equal(out, sel_aggregate_act_reference(
        sel, pseudo, proj, gparams, relu=True))
    res = sel_aggregate_act_residuals(sel, pseudo, proj, gparams, True, 0.5,
                                      seeds)
    ref = sel_aggregate_act_residuals_reference(sel, pseudo, proj, gparams,
                                                True, 0.5, seeds)
    assert all(torch.equal(a, b) for a, b in zip(res, ref))
    g = torch.randn(proj.shape, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    grads = sel_aggregate_act_vjp(g, sel, res[1], res[2], pseudo, proj,
                                  gparams, res[0], 0.5)
    want = sel_aggregate_act_vjp_reference(g, sel, res[1], res[2], pseudo,
                                           proj, gparams, res[0], 0.5)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    assert [f.launches for f in counters] == before
