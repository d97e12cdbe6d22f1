"""MCAN's inputs and weights, made from a run's seed.

- ``program_config``: the program's ModelConfig fields of a
  configuration's ``model`` section (mcan-vqa's names in lower case;
  the program takes the heads, the depth and AttFlat's widths as MCAN's
  configurations fix them, the FFN's and AttFlat's output widths as 4
  and 2 hidden widths, and refuses a configuration that differs);
- ``region_table``: the device table of region features (N, K, F) in
  bfloat16, uniform in [0, 1), each image's rows past its region count
  zero, and the counts (N,) int32, uniform on the configuration's range
  and drawn on the host, so that the loader counts padding from them;
- ``make_weights``: every leaf under mcan-vqa's state_dict names, drawn
  on the card as torch's default initializers draw them (each Linear's
  weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the LSTM's
  U(-1/sqrt(H), 1/sqrt(H)), the embedding N(0, 1)), each layer norm at
  a = 1, b = 0, MCAN's own start.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.harness.data import rng, torch_seed

# the port's stores carry 4 box columns after the features; MCAN reads
# the features only
BOX = 4


def program_config(m: dict) -> dict:
    """The program's ``ModelConfig`` keyword arguments. The keys that
    ``ModelConfig`` does not take must equal the program's constants, or
    this raises: the reference and the counts read them from ``m``."""
    from vqa_project_tpu_torch.models import mcan
    h = m["hidden_size"]
    fixed = {"multi_head": mcan.N_HEADS, "layer": mcan.N_LAYERS,
             "flat_mlp_size": mcan.FLAT_MLP, "flat_glimpses": mcan.GLIMPSES,
             "ff_size": 4 * h, "flat_out_size": 2 * h,
             "hidden_size_head": h // mcan.N_HEADS}
    differ = {k: (m[k], v) for k, v in fixed.items() if m[k] != v}
    if differ:
        raise ValueError("the program fixes these widths otherwise "
                         f"(configuration, program): {differ}")
    return dict(arch="mcan", vocab_size=m["vocab_size"],
                emb_dim=m["word_embed_size"],
                feat_dim=m["img_feat_size"] + BOX, hid_dim=m["hidden_size"],
                out_dim=m["answer_size"] + 1, n_obj=m["img_feat_pad_size"],
                max_qlen=m["max_token"], dropout=m["dropout_r"],
                compute_dtype=m["compute_dtype"])


def region_counts(n_images: int, m: dict, seed: int) -> np.ndarray:
    lo, hi = m["regions"]
    return rng(seed, "regions").integers(lo, hi + 1, size=n_images,
                                         dtype=np.int32)


def region_table(n_images: int, m: dict, seed: int, device):
    """(features (N, K, F) bfloat16 on ``device``, counts (N,) int32
    numpy): uniform [0, 1) rows, zero from each image's count on."""
    k, f = m["img_feat_pad_size"], m["img_feat_size"]
    counts = region_counts(n_images, m, seed)
    g = torch.Generator(device=device).manual_seed(torch_seed(seed, "feat"))
    feats = torch.rand((n_images, k, f), generator=g, device=device,
                       dtype=torch.bfloat16)
    dead = (torch.arange(k, device=device)[None, :]
            >= torch.from_numpy(counts).to(device)[:, None])
    feats.masked_fill_(dead[:, :, None], 0.0)
    return feats, counts


def leaves(m: dict) -> List[Tuple[str, tuple, float]]:
    """(name, shape, bound) of every uniform leaf, in draw order."""
    h, ff, e = m["hidden_size"], m["ff_size"], m["word_embed_size"]
    mlp, g, fo = m["flat_mlp_size"], m["flat_glimpses"], m["flat_out_size"]
    out: List[Tuple[str, tuple, float]] = []

    def lin(name, rows, cols):
        b = 1.0 / math.sqrt(cols)
        out.extend([(f"{name}.weight", (rows, cols), b),
                    (f"{name}.bias", (rows,), b)])

    b = 1.0 / math.sqrt(h)
    out += [("lstm.weight_ih_l0", (4 * h, e), b),
            ("lstm.weight_hh_l0", (4 * h, h), b),
            ("lstm.bias_ih_l0", (4 * h,), b),
            ("lstm.bias_hh_l0", (4 * h,), b)]
    lin("img_feat_linear", h, m["img_feat_size"])

    def att(name):
        for part in ("v", "k", "q", "merge"):
            lin(f"{name}.linear_{part}", h, h)

    def ffn(name):
        lin(f"{name}.mlp.fc.linear", ff, h)
        lin(f"{name}.mlp.linear", h, ff)

    for i in range(m["layer"]):
        att(f"backbone.enc_list.{i}.mhatt")
        ffn(f"backbone.enc_list.{i}.ffn")
    for i in range(m["layer"]):
        att(f"backbone.dec_list.{i}.mhatt1")
        att(f"backbone.dec_list.{i}.mhatt2")
        ffn(f"backbone.dec_list.{i}.ffn")
    for name in ("attflat_img", "attflat_lang"):
        lin(f"{name}.mlp.fc.linear", mlp, h)
        lin(f"{name}.mlp.linear", g, mlp)
        lin(f"{name}.linear_merge", fo, h * g)
    lin("proj", m["answer_size"], fo)
    return out


def norms(m: dict) -> List[Tuple[str, int]]:
    """(name, width) of every layer norm."""
    h = m["hidden_size"]
    out = []
    for i in range(m["layer"]):
        out += [(f"backbone.enc_list.{i}.norm{j}", h) for j in (1, 2)]
    for i in range(m["layer"]):
        out += [(f"backbone.dec_list.{i}.norm{j}", h) for j in (1, 2, 3)]
    return out + [("proj_norm", m["flat_out_size"])]


def n_params(m: dict) -> int:
    return (sum(math.prod(s) for _, s, _ in leaves(m))
            + sum(2 * n for _, n in norms(m))
            + m["vocab_size"] * m["word_embed_size"])


def make_weights(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter of the model in float32 on ``device``."""
    spec = leaves(m)
    total = sum(math.prod(s) for _, s, _ in spec)
    g = torch.Generator(device=device).manual_seed(torch_seed(seed, "w"))
    flat = torch.rand(total, generator=g, device=device)
    w: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, bound in spec:
        k = math.prod(shape)
        w[name] = (flat[at:at + k] * (2 * bound) - bound).reshape(shape)
        at += k
    w["embedding.weight"] = torch.randn(
        (m["vocab_size"], m["word_embed_size"]), generator=g, device=device)
    for name, n in norms(m):
        w[f"{name}.a_2"] = torch.ones(n, device=device)
        w[f"{name}.b_2"] = torch.zeros(n, device=device)
    return w
