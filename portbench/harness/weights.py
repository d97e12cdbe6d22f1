"""The model's weights, made from the seed on the card.

One uniform draw and one normal draw of a ``torch.Generator`` on the
card hold every leaf; each leaf is a slice of them, scaled as torch's
default initializers scale it (Linear and GRU: U(-1/sqrt(fan_in), ..);
the embedding N(0, 1); each weight-norm g the norm of its v, so that
w == v; the Gaussian means and precisions over their ranges). The names
are the reference's state_dict names, which the program loads as they
are and the plain reference reads.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.harness.data import torch_seed


def leaves(m: dict) -> List[Tuple[str, tuple, float, float]]:
    """(name, shape, low, high) of every uniform leaf, in draw order.
    ``m`` is the configuration's model section."""
    h, e, f = m["hid_dim"], m["emb_dim"], m["feat_dim"]
    c, n, o = m["combined_dim"], m["n_kernels"], m["out_dim"]
    out: List[Tuple[str, tuple, float, float]] = []

    def lin(name, rows, cols, bias=True):
        b = 1.0 / math.sqrt(cols)
        out.append((f"{name}.weight_v", (rows, cols), -b, b))
        if bias:
            out.append((f"{name}.bias", (rows,), -b, b))

    b = 1.0 / math.sqrt(h)
    out += [("q_gru.weight_ih_l0", (3 * h, e), -b, b),
            ("q_gru.weight_hh_l0", (3 * h, h), -b, b),
            ("q_gru.bias_ih_l0", (3 * h,), -b, b),
            ("q_gru.bias_hh_l0", (3 * h,), -b, b)]
    lin("adjacency_1.edge_layer_1", c, f + h)
    lin("adjacency_1.edge_layer_2", c, c)
    for conv, cin, cout in (("graph_convolution_1", f, 2 * h),
                            ("graph_convolution_2", 2 * h, h)):
        bw = 1.0 / math.sqrt(cin)
        for i in range(n):
            out.append((f"{conv}.conv_weights.{i}.weight", (cout // n, cin),
                        -bw, bw))
        out += [(f"{conv}.mean_rho", (n, 1), 0.0, 1.0),
                (f"{conv}.mean_theta", (n, 1), -math.pi, math.pi),
                (f"{conv}.precision_rho", (n, 1), 0.0, 1.0),
                (f"{conv}.precision_theta", (n, 1), 0.0, 1.0)]
    lin("out_1", o, h)
    lin("out_2", o, o)
    return out


def make_weights(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter of the model in float32 on ``device``."""
    spec = leaves(m)
    total = sum(math.prod(s) for _, s, _, _ in spec)
    g = torch.Generator(device=device).manual_seed(torch_seed(seed, "w"))
    flat = torch.rand(total, generator=g, device=device)
    w: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, lo, hi in spec:
        k = math.prod(shape)
        w[name] = (flat[at:at + k] * (hi - lo) + lo).reshape(shape)
        at += k
    w["wembed.weight"] = torch.randn((m["vocab_size"], m["emb_dim"]),
                                     generator=g, device=device)
    for name in [n for n in w if n.endswith(".weight_v")]:
        w[name[:-2] + "_g"] = w[name].norm(dim=1, keepdim=True)
    return w
