"""Plain version of the edge-aggregation kernel (and its wrapper on CPU
tensors) against the JAX Pallas kernel in interpret mode.

The CUDA kernel itself is held against the same plain version on the
card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_project_tpu.ops.neighbourhood import masked_neighbourhood
from vqa_project_tpu.ops.pallas.edge_aggregate import \
    fused_sel_aggregate_act as j_fused
from vqa_project_tpu_torch.ops.edge_aggregate import (
    fused_sel_aggregate_act, sel_aggregate_act_reference)

N_KERN, D, B = 4, 8, 2


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
    return sel, pseudo, proj, gparams


def _close(got, want, tol=1e-5):
    # sums run in another order: error normalized by the output's scale
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got / scale, want / scale, atol=tol)


@pytest.mark.parametrize("k,m", [(10, 5), (51, 19)])
@pytest.mark.parametrize("use_alpha", [True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_plain_and_wrapper_match_pallas(rng, k, m, use_alpha, relu):
    sel, pseudo, proj, gparams = _inputs(rng, k, m, use_alpha)
    want = np.asarray(j_fused(
        jnp.asarray(sel), jnp.asarray(pseudo), jnp.asarray(proj),
        jnp.asarray(gparams), None, relu, 0.0, True))
    args = [torch.from_numpy(a) for a in (sel, pseudo, proj, gparams)]
    plain = sel_aggregate_act_reference(*args, relu=relu).numpy()
    _close(plain, want)
    before = fused_sel_aggregate_act.launches
    wrapped = fused_sel_aggregate_act(*args, relu=relu).numpy()
    np.testing.assert_array_equal(wrapped, plain)
    # CPU tensors take the plain version: no kernel launch is counted
    assert fused_sel_aggregate_act.launches == before


def test_bf16_proj_keeps_dtype(rng):
    sel, pseudo, proj, gparams = _inputs(rng, 10, 5, True)
    args = [torch.from_numpy(a) for a in (sel, pseudo, proj, gparams)]
    args[2] = args[2].to(torch.bfloat16)
    out = fused_sel_aggregate_act(*args, relu=True)
    assert out.dtype == torch.bfloat16 and out.shape == args[2].shape
    ref = sel_aggregate_act_reference(
        args[0], args[1], args[2].float(), args[3], relu=True)
    _close(out.float().numpy(), ref.numpy(), tol=1e-2)


def test_dropout_not_ported(rng):
    """In-kernel dropout is ported now: it needs per-image seeds, and
    with them keeps a subset of the relu output, scaled by 1/(1-p)."""
    sel, pseudo, proj, gparams = _inputs(rng, 10, 5, True)
    args = [torch.from_numpy(a) for a in (sel, pseudo, proj, gparams)]
    with pytest.raises(ValueError, match="seeds"):
        fused_sel_aggregate_act(*args, relu=True, dropout_rate=0.5)
    seeds = torch.tensor([3, 4], dtype=torch.int32)
    out = fused_sel_aggregate_act(*args, relu=True, dropout_rate=0.5,
                                  seeds=seeds)
    plain = sel_aggregate_act_reference(*args, relu=True)
    kept = out != 0
    assert 0 < int(kept.sum()) < int((plain > 0).sum())
    np.testing.assert_allclose(out[kept].numpy(), 2 * plain[kept].numpy(),
                               rtol=1e-6)


def _bad(args, case):
    sel, pseudo, proj, gparams = args
    if case == "sel_dtype":
        sel = sel.double()
    elif case == "pseudo_shape":
        pseudo = pseudo[..., :1]
    elif case == "proj_dtype":
        proj = proj.half()
    elif case == "proj_strided":
        proj = proj.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "gparams_shape":
        gparams = gparams[:3]
    elif case == "width":
        proj = proj[..., :-1].contiguous()
    return sel, pseudo, proj, gparams


@pytest.mark.parametrize("case", ["sel_dtype", "pseudo_shape", "proj_dtype",
                                  "proj_strided", "gparams_shape", "width"])
def test_kernel_input_checks(rng, case):
    """What the CUDA wrapper refuses before a launch (the checks do not
    depend on the device, so they run here on CPU tensors)."""
    from vqa_project_tpu_torch.ops.edge_aggregate import _check_cuda_inputs

    args = [torch.from_numpy(a) for a in _inputs(rng, 10, 5, True)]
    assert _check_cuda_inputs(*args) == (B, 10, N_KERN, D)
    with pytest.raises((TypeError, ValueError)):
        _check_cuda_inputs(*_bad(args, case))
