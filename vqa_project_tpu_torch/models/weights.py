"""Carry weights into and out of the port's state_dict layout.

The port's parameter names and shapes are the reference's torch
state_dict (see ``models/graph_vqa.py``). Two sources feed it:

- ``state_dict_from_jax_params``: the JAX package's parameter tree,
  given as numpy-convertible arrays. Flax kernels are (in, out) and the
  fused conv kernel (in, n*d) splits into n (d, in) Linears.
- ``load_reference_checkpoint``: a reference ``.pt`` file, either a
  bare state_dict or the full training dict ``{..., "state_dict"}``;
  both weight-norm namings (``weight_g``/``weight_v`` and
  ``parametrizations.weight.original0/1``) are accepted.

``export_reference_state_dict`` goes the other way: the bare reference
state_dict, as the JAX package's ``export_torch_state_dict`` writes it.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_GAUSSIANS = ("mean_rho", "mean_theta", "precision_rho", "precision_theta")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


def _weight_norm(sd: Dict[str, torch.Tensor], prefix: str,
                 leaf: Mapping) -> None:
    sd[f"{prefix}.weight_g"] = _t(leaf["g"]).reshape(-1, 1)
    sd[f"{prefix}.weight_v"] = _t(np.asarray(leaf["v"]).T)
    sd[f"{prefix}.bias"] = _t(leaf["b"])


def state_dict_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``{'params': {...}}`` tree (or its inner dict) as the
    port's float32 state_dict."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {
        "wembed.weight": _t(p["wembed"]),
        "q_gru.weight_ih_l0": _t(p["gru_w_ih"]),
        "q_gru.weight_hh_l0": _t(p["gru_w_hh"]),
        "q_gru.bias_ih_l0": _t(p["gru_b_ih"]),
        "q_gru.bias_hh_l0": _t(p["gru_b_hh"]),
    }
    for name in ("edge_layer_1", "edge_layer_2"):
        _weight_norm(sd, f"adjacency_1.{name}", p["adjacency_1"][name])
    for conv in ("graph_convolution_1", "graph_convolution_2"):
        leaf = p[conv]
        n_kernels = int(np.asarray(leaf["mean_rho"]).shape[0])
        fused = np.asarray(leaf["conv_kernels"], np.float32)  # (in, n*d)
        d = fused.shape[1] // n_kernels
        for i in range(n_kernels):
            sd[f"{conv}.conv_weights.{i}.weight"] = _t(
                fused[:, i * d:(i + 1) * d].T)               # (d, in)
        for gname in _GAUSSIANS:
            sd[f"{conv}.{gname}"] = _t(leaf[gname]).reshape(-1, 1)
    _weight_norm(sd, "out_1", p["out_1"])
    _weight_norm(sd, "out_2", p["out_2"])
    return sd


def reference_name(key: str) -> str:
    """A reference state_dict key under the port's name (the
    parametrize weight-norm naming -> weight_g / weight_v)."""
    return (key.replace(".parametrizations.weight.original0", ".weight_g")
               .replace(".parametrizations.weight.original1", ".weight_v"))


def reference_state_dict(ckpt: Mapping) -> Dict[str, torch.Tensor]:
    """A loaded reference checkpoint (bare state_dict or full dict) as a
    float32 state_dict under the port's names."""
    sd = ckpt
    if isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    return {reference_name(key): value.float() for key, value in sd.items()}


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """``torch.load(weights_only=True)`` of a reference checkpoint, as a
    state_dict the port's model loads directly."""
    return reference_state_dict(
        torch.load(path, map_location="cpu", weights_only=True))


def _reference_names(n_kernels: int):
    """The reference state_dict's keys, in the order the JAX package's
    export writes them."""
    names = ["wembed.weight", "q_gru.weight_ih_l0", "q_gru.weight_hh_l0",
             "q_gru.bias_ih_l0", "q_gru.bias_hh_l0"]
    wn = ("weight_g", "weight_v", "bias")
    for layer in ("edge_layer_1", "edge_layer_2"):
        names += [f"adjacency_1.{layer}.{p}" for p in wn]
    for conv in ("graph_convolution_1", "graph_convolution_2"):
        names += [f"{conv}.conv_weights.{i}.weight" for i in range(n_kernels)]
        names += [f"{conv}.{g}" for g in _GAUSSIANS]
    for layer in ("out_1", "out_2"):
        names += [f"{layer}.{p}" for p in wn]
    return names


def export_reference_state_dict(state_dict: Mapping
                                ) -> Dict[str, torch.Tensor]:
    """The bare reference state_dict of the port's weights (a model's
    ``state_dict()`` or a checkpoint's), float32 on the CPU: weight-norm
    layers as ``weight_g`` (out, 1), ``weight_v`` (out, in) and ``bias``,
    each conv kernel as ``conv_weights.{i}.weight`` (d, in), the Gaussian
    parameters (n, 1). The counterpart of the JAX package's
    ``models/torch_import.py::export_torch_state_dict``. Raises
    ValueError for other names (a quantized model's, say) or shapes."""
    n_kernels = int(state_dict["graph_convolution_1.mean_rho"].shape[0])
    names = _reference_names(n_kernels)
    if set(state_dict) != set(names):
        raise ValueError("not the reference's parameter names: "
                         f"{sorted(set(state_dict) ^ set(names))}")
    out = {k: state_dict[k].detach().to("cpu", torch.float32).contiguous()
           for k in names}
    for k, v in out.items():
        prefix, leaf = k.rsplit(".", 1)
        if leaf in _GAUSSIANS and tuple(v.shape) != (n_kernels, 1):
            raise ValueError(f"{k} is {tuple(v.shape)}, want ({n_kernels}, 1)")
        if (leaf == "weight_g" and tuple(v.shape)
                != (out[prefix + ".weight_v"].shape[0], 1)):
            raise ValueError(f"{k} is {tuple(v.shape)}, want (out, 1)")
    return out
