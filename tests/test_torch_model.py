"""The port's whole forward against the JAX model, on CPU, f32.

JAX runs both its Pallas path (kernels in interpret mode) and its plain
XLA path; the port runs its plain versions (CPU tensors), on the same
weights carried across by state_dict_from_jax_params or loaded from a
reference-format torch state_dict.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.test_model import CFG, make_batch
from tests.test_torch_import import _make_torch_state_dict
from vqa_project_tpu.models import GraphVQAModel as JaxModel
from vqa_project_tpu.models.torch_import import import_torch_state_dict
from vqa_project_tpu_torch.config import ModelConfig
from vqa_project_tpu_torch.models import (GraphVQAModel,
                                          load_reference_checkpoint,
                                          state_dict_from_jax_params)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def flush_denormals():
    """XLA:CPU flushes denormal floats to zero and torch's CPU kernels do
    not; h_max_indices is an argmax over relu outputs, where a denormal
    against exact zeros decides the index. Run torch in XLA's mode."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _port_cfg(cfg=CFG) -> ModelConfig:
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                          if k in fields})


def _port_forward(sd, q, image, qlen):
    model = GraphVQAModel(_port_cfg(), device="cpu")
    model.load_state_dict(sd)
    out = model(torch.from_numpy(np.asarray(q)),
                torch.from_numpy(np.asarray(image)),
                torch.from_numpy(np.asarray(qlen)))
    return [o.numpy() for o in out]


def _assert_agree(port, jax_out):
    logits_p, adj_p, hmax_p = port
    logits_j, adj_j, hmax_j = (np.asarray(o) for o in jax_out)
    np.testing.assert_allclose(adj_p, adj_j, **TOL)
    np.testing.assert_allclose(logits_p, logits_j, **TOL)
    np.testing.assert_array_equal(logits_p.argmax(-1), logits_j.argmax(-1))
    np.testing.assert_array_equal(hmax_p, hmax_j)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_forward_matches_jax_params(rng, use_pallas):
    q, image, qlen = make_batch(rng)
    jmodel = JaxModel(cfg=dataclasses.replace(CFG, use_pallas=use_pallas))
    params = jmodel.init(jax.random.key(3), q, image, qlen)
    want = jmodel.apply(params, q, image, qlen)
    got = _port_forward(state_dict_from_jax_params(params), q, image, qlen)
    _assert_agree(got, want)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_forward_matches_on_reference_state_dict(rng, use_pallas):
    """The reference-format state_dict loads into the port as it is."""
    sd = _make_torch_state_dict(CFG)
    q, image, qlen = make_batch(rng)
    jmodel = JaxModel(cfg=dataclasses.replace(CFG, use_pallas=use_pallas))
    want = jmodel.apply(import_torch_state_dict(sd), q, image, qlen)
    _assert_agree(_port_forward(sd, q, image, qlen), want)


def test_state_dict_keys_are_the_reference_keys(rng):
    sd_ref = _make_torch_state_dict(CFG)
    port = GraphVQAModel(_port_cfg(), device="cpu").state_dict()
    assert set(port) == set(sd_ref)
    for k, v in sd_ref.items():
        assert tuple(port[k].shape) == tuple(v.shape), k
    q, image, qlen = make_batch(rng)
    params = JaxModel(cfg=CFG).init(jax.random.key(0), q, image, qlen)
    assert set(state_dict_from_jax_params(params)) == set(sd_ref)


@pytest.mark.parametrize("layout", ["bare", "full_dict", "parametrize"])
def test_load_reference_checkpoint(tmp_path, layout):
    sd = _make_torch_state_dict(CFG)
    if layout == "full_dict":
        payload = {"epoch": 3, "state_dict": sd, "optimizer": {}}
    elif layout == "parametrize":
        payload = {k.replace(".weight_g", ".parametrizations.weight."
                             "original0")
                   .replace(".weight_v", ".parametrizations.weight."
                            "original1"): v for k, v in sd.items()}
    else:
        payload = sd
    path = str(tmp_path / "ref.pt")
    torch.save(payload, path)
    loaded = load_reference_checkpoint(path)
    assert set(loaded) == set(sd)
    model = GraphVQAModel(_port_cfg(), device="cpu")
    model.load_state_dict(loaded)
    for k, v in sd.items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)


def test_bf16_forward_runs_and_train_raises(rng):
    """The bf16 forward runs; train mode (which raised before the
    training slice) now runs too, with finite logits and a finite,
    non-zero gradient on every parameter."""
    q, image, qlen = (torch.from_numpy(np.array(a))
                      for a in make_batch(rng))
    cfg = dataclasses.replace(_port_cfg(), compute_dtype="bfloat16")
    model = GraphVQAModel(cfg, device="cpu", seed=5)
    logits, adj, hmax = model(q, image, qlen)
    assert logits.dtype == torch.float32 and adj.dtype == torch.float32
    assert torch.isfinite(logits).all()
    assert hmax.shape == (q.shape[0], CFG.hid_dim)
    assert logits.grad_fn is None            # eval records no graph
    logits, _, _ = model(q, image, qlen, train=True,
                         generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(logits).all() and logits.grad_fn is not None
    logits.square().mean().backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().sum() > 0, name
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GraphVQAModel(cfg)  # the default device is the card
