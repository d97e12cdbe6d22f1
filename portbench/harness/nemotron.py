"""Nemotron-H's sizes and weights, made from a run's seed.

- ``spec``: one dict of the configuration's sizes, its top-level keys
  (the source's config.json as run) with its ``model`` section over them
  (what the VQA model adds, and the cell's tests' smaller widths);
- ``program_config``: the program's ModelConfig keyword arguments;
- ``leaves``: every parameter's name, shape and how it is drawn;
- ``make_weights``: every parameter in float32 on the card, drawn from
  the seed in ``leaves``' order as Nemotron-H initializes them
  (``models/nemotron_h.py::NemotronHModel.reset_parameters`` states the
  same rule), the correction bias 0.

The region table and its counts are MCAN's (``harness/mcan.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.harness.data import torch_seed

BOX = 4


def spec(config: dict) -> dict:
    """The sizes of a configuration file's dict (``Cell.config``)."""
    top = {k: v for k, v in config.items()
           if k not in ("name", "source", "about", "model", "train", "data",
                        "reduced", "deployment", "assumed")}
    return {**top, **config["model"]}


def program_config(m: dict) -> dict:
    """The program's ``ModelConfig`` keyword arguments of ``spec``'s
    dict: the router over ``router_experts``, holding
    ``n_routed_experts`` of them from ``first_held_expert``."""
    names = ("hybrid_override_pattern", "num_hidden_layers",
             "mamba_num_heads", "mamba_head_dim", "ssm_state_size",
             "n_groups", "conv_kernel", "chunk_size", "time_step_min",
             "time_step_max", "time_step_floor", "num_experts_per_tok",
             "moe_intermediate_size", "moe_shared_expert_intermediate_size",
             "routed_scaling_factor", "num_attention_heads",
             "num_key_value_heads", "head_dim", "layer_norm_epsilon",
             "initializer_range", "first_held_expert")
    sizes = {k: m[k] for k in names}
    sizes.update(n_routed_experts=m["router_experts"],
                 n_held_experts=m["n_routed_experts"])
    return dict(arch="nemotron_h", vocab_size=m["vocab_size"],
                emb_dim=m["hidden_size"], feat_dim=m["img_feat_size"] + BOX,
                hid_dim=m["hidden_size"], out_dim=m["answer_size"] + 1,
                n_obj=m["img_feat_pad_size"], max_qlen=m["max_token"],
                dropout=0.0, compute_dtype=m["compute_dtype"],
                arch_sizes=sizes)


def pattern(m: dict) -> str:
    return m["hybrid_override_pattern"][:m["num_hidden_layers"]]


def leaves(m: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, draw) of every parameter, in draw order; draw is
    "normal" (N(0, initializer_range)), "zero", "one", "conv" (U(-1 /
    sqrt(W), 1 / sqrt(W))), "out" (U(-1 / sqrt(fan_in), ..) / sqrt(depth)),
    "a_log", "dt_bias"."""
    h, f = m["hidden_size"], m["img_feat_size"]
    nh, p = m["mamba_num_heads"], m["mamba_head_dim"]
    g, n, w = m["n_groups"], m["ssm_state_size"], m["conv_kernel"]
    inner = nh * p
    conv = inner + 2 * g * n
    q, kv, d = (m["num_attention_heads"], m["num_key_value_heads"],
                m["head_dim"])
    held, i_e = m["n_routed_experts"], m["moe_intermediate_size"]
    out = [("multi_modal_projector.linear_1.weight", (h, f), "normal"),
           ("multi_modal_projector.linear_1.bias", (h,), "zero"),
           ("multi_modal_projector.linear_2.weight", (h, h), "normal"),
           ("multi_modal_projector.linear_2.bias", (h,), "zero"),
           ("backbone.embeddings.weight", (m["vocab_size"], h), "normal")]
    for i, kind in enumerate(pattern(m)):
        b = f"backbone.layers.{i}"
        out.append((f"{b}.norm.weight", (h,), "one"))
        x = f"{b}.mixer"
        if kind == "M":
            out += [(f"{x}.in_proj.weight", (inner + conv + nh, h), "normal"),
                    (f"{x}.conv1d.weight", (conv, 1, w), "conv"),
                    (f"{x}.conv1d.bias", (conv,), "conv"),
                    (f"{x}.dt_bias", (nh,), "dt_bias"),
                    (f"{x}.A_log", (nh,), "a_log"),
                    (f"{x}.D", (nh,), "one"),
                    (f"{x}.norm.weight", (inner,), "one"),
                    (f"{x}.out_proj.weight", (h, inner), "out")]
        elif kind == "*":
            out += [(f"{x}.q_proj.weight", (q * d, h), "normal"),
                    (f"{x}.k_proj.weight", (kv * d, h), "normal"),
                    (f"{x}.v_proj.weight", (kv * d, h), "normal"),
                    (f"{x}.o_proj.weight", (h, q * d), "normal")]
        else:
            s = m["moe_shared_expert_intermediate_size"]
            out += [(f"{x}.gate.weight", (m["router_experts"], h), "normal"),
                    (f"{x}.experts.up_proj", (held, i_e, h), "normal"),
                    (f"{x}.experts.down_proj", (held, h, i_e), "normal"),
                    (f"{x}.shared_experts.up_proj.weight", (s, h), "normal"),
                    (f"{x}.shared_experts.down_proj.weight", (h, s),
                     "normal")]
    out += [("backbone.norm_f.weight", (h,), "one"),
            ("classifier.weight", (m["answer_size"], h), "normal")]
    return out


def n_params(m: dict) -> int:
    return sum(math.prod(s) for _, s, _ in leaves(m))


def make_weights(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter in float32 on ``device`` and the correction
    biases, drawn as ``leaves`` says from the seed's stream "w"."""
    g = torch.Generator(device=device).manual_seed(torch_seed(seed, "w"))
    std = m["initializer_range"]
    w: Dict[str, torch.Tensor] = {}
    for name, shape, draw in leaves(m):
        if draw == "normal":
            t = torch.randn(shape, generator=g, device=device) * std
        elif draw in ("zero", "one"):
            t = torch.full(shape, float(draw == "one"), device=device)
        elif draw in ("conv", "out"):
            fan = m["conv_kernel"] if draw == "conv" else shape[1]
            bound = 1.0 / math.sqrt(fan)
            t = torch.rand(shape, generator=g, device=device) * (2 * bound) \
                - bound
            if draw == "out":
                t = t / math.sqrt(m["num_hidden_layers"])
        elif draw == "a_log":
            t = torch.log(torch.arange(1, shape[0] + 1, device=device,
                                       dtype=torch.float32))
        else:
            lo = math.log(m["time_step_min"])
            hi = math.log(m["time_step_max"])
            dt = torch.exp(torch.rand(shape, generator=g, device=device)
                           * (hi - lo) + lo).clamp(min=m["time_step_floor"])
            t = dt + torch.log(-torch.expm1(-dt))
        w[name] = t
    for i, kind in enumerate(pattern(m)):
        if kind == "E":
            w[f"backbone.layers.{i}.mixer.gate.e_score_correction_bias"] = \
                torch.zeros(m["router_experts"], device=device)
    return w
