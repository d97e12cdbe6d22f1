"""The plain reference of the conditioned-graph VQA model, in float32.

Written from the model's description (Norcliffe-Brown et al., "Learning
Conditioned Graph Structures for Interpretable Visual Question
Answering", arXiv:1806.07243) and the reference implementation's
conventions, with plain torch operations only: no kernel, cache or
batching of the program under test, and nothing imported from it.

    nodes   = [features || box]                        (B, K, F)
    q       = GRU(embed(question)), frozen past qlen   (B, H)
    E       = relu(WN2(relu(WN1([nodes || q]))))       (B, K, C)
    A       = E E^T; top-m per row (ties: lowest index), softmax over them
    pseudo  = polar (rho, theta = atan2(dx, dy)) between box centres
    conv(x) = sum_j sel_ij * w_k(pseudo_ij) * (x_j W_k), per Gaussian k,
              w normalized over the kernels (denominator >= 1e-20)
    h1      = relu(conv1(nodes, alpha)); h2 = relu(conv2(h1, top-m mask))
    logits  = WN_o2(relu(WN_o1(relu(q) * max_K h2)))

WN is a weight-normed linear layer, y = x v^T g / ||v|| + b. In
training, dropout acts on the nodes, on conv1's output and after the
classifier's first layer; ``Draws`` gives its masks (``dropout.py``).

``precision="fp8"`` rounds both operands of every product to float8
e4m3 with a per-tensor scale (sums stay float32): the control that a
computation one precision below the configured bfloat16 must fail.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from portbench.reference.dropout import Draws, philox_keep

_E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under a per-tensor scale; the gradient passes
    straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / _E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


class Reference:
    """The forward and loss at a configuration's widths, in float32 (or
    with fp8 operands, the control)."""

    def __init__(self, m: dict, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)
        self.m = m
        self.q = _fp8 if precision == "fp8" else (lambda t: t)

    def mm(self, a, b):
        return torch.matmul(self.q(a), self.q(b))

    def wn(self, w, name, x):
        v, g, b = (w[f"{name}.weight_v"], w[f"{name}.weight_g"],
                   w[f"{name}.bias"])
        scale = g.reshape(-1) / v.norm(dim=1).clamp(min=1e-12)
        return self.mm(x, v.t()) * scale + b

    def gru(self, w, emb, qlen):
        h3 = w["q_gru.weight_hh_l0"].shape[0]
        hid = h3 // 3
        xp = self.mm(emb, w["q_gru.weight_ih_l0"].t()) + w["q_gru.bias_ih_l0"]
        h = emb.new_zeros((emb.shape[0], hid))
        for t in range(emb.shape[1]):
            hp = self.mm(h, w["q_gru.weight_hh_l0"].t()) + w["q_gru.bias_hh_l0"]
            xr, xz, xn = xp[:, t].split(hid, dim=-1)
            hr, hz, hn = hp.split(hid, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = torch.where((t < qlen)[:, None], (1 - z) * n + z * h, h)
        return h

    @staticmethod
    def top_m(adj, m):
        """(alpha, mask): exactly m neighbours a row, the largest, ties
        to the lower index (a stable sort keeps equal values in index
        order)."""
        order = torch.argsort(-adj, dim=-1, stable=True)[..., :m]
        mask = torch.zeros_like(adj).scatter_(-1, order, 1.0)
        alpha = torch.softmax(adj.masked_fill(mask == 0, float("-inf")), -1)
        return alpha, mask

    @staticmethod
    def pseudo(boxes):
        c = boxes[..., :2] + 0.5 * (boxes[..., 2:] - boxes[..., :2])
        d = c[:, :, None, :] - c[:, None, :, :]
        rho = torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)
        theta = torch.atan2(d[..., 0], d[..., 1])
        return rho, theta

    def conv(self, w, name, x, sel, rho, theta):
        n = self.m["n_kernels"]
        wk = torch.cat([w[f"{name}.conv_weights.{i}.weight"]
                        for i in range(n)])
        proj = self.mm(x, wk.t())                        # (B, K, n d)
        b, k, nd = proj.shape
        mr, mt = w[f"{name}.mean_rho"].reshape(-1), w[f"{name}.mean_theta"].reshape(-1)
        pr = w[f"{name}.precision_rho"].reshape(-1)
        pt = w[f"{name}.precision_theta"].reshape(-1)
        wr = torch.exp(-0.5 * (rho[..., None] - mr) ** 2 / (1e-14 + pr ** 2))
        dt = torch.abs(theta[..., None] - mt)
        dt = torch.minimum(dt, torch.abs(2 * math.pi - dt))
        wt = torch.exp(-0.5 * dt ** 2 / (1e-14 + pt ** 2))
        g = wr * wt
        g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
        g = g / g.sum(-1, keepdim=True).clamp(min=1e-20)  # (B, K, K, n)
        edge = (g * sel[..., None]).permute(0, 3, 1, 2)   # (B, n, K, K)
        p4 = proj.reshape(b, k, n, nd // n).permute(0, 2, 1, 3)
        out = self.mm(edge, p4)                           # (B, n, K, d)
        return out.permute(0, 2, 1, 3).reshape(b, k, nd)

    def forward(self, w: Dict[str, torch.Tensor], question, qlen, feats,
                boxes, draws: Optional[Draws] = None):
        """logits (B, out) float32. ``feats`` (B, K, F-4) and ``boxes``
        (B, K, 4) float32; ``draws`` the dropout masks of a training
        step (None: eval)."""
        m = self.m
        nodes = torch.cat([feats, boxes], dim=-1)
        if draws is not None:
            nodes = draws.apply(nodes, draws.u_nodes)
        emb = w["wembed.weight"][question.long()]
        q = self.gru(w, emb, qlen.long())
        e = torch.relu(self.wn(w, "adjacency_1.edge_layer_1", torch.cat(
            [nodes, q[:, None, :].expand(-1, nodes.shape[1], -1)], -1)))
        e = torch.relu(self.wn(w, "adjacency_1.edge_layer_2", e))
        adj = self.mm(e, e.transpose(1, 2))
        alpha, mask = self.top_m(adj, m["neighbourhood_size"])
        rho, theta = self.pseudo(boxes)
        h1 = torch.relu(self.conv(w, "graph_convolution_1", nodes, alpha,
                                  rho, theta))
        if draws is not None:
            keep = philox_keep(draws.seeds, h1.shape[1:], draws.rate)
            h1 = torch.where(keep, h1 / (1.0 - draws.rate),
                             torch.zeros_like(h1))
        h2 = torch.relu(self.conv(w, "graph_convolution_2", h1, mask,
                                  rho, theta))
        fused = torch.relu(q) * h2.amax(dim=1)
        o1 = torch.relu(self.wn(w, "out_1", fused))
        if draws is not None:
            o1 = draws.apply(o1, draws.u_out)
        return self.wn(w, "out_2", o1)


def soft_margin_loss(logits, targets, mask):
    """Mean over the valid rows of the class-mean of
    y softplus(-x) + (1 - y) softplus(x)."""
    per = (targets * F.softplus(-logits)
           + (1 - targets) * F.softplus(logits)).mean(-1)
    per = torch.where(mask > 0, per, torch.zeros_like(per))
    return per.sum() / mask.sum().clamp(min=1.0)


def dense_labels(idx, val, n_out):
    """Sparse (B, S) entries -> dense (B, n_out); the last column, the
    pad answer, is 0."""
    d = torch.zeros((idx.shape[0], n_out), device=idx.device)
    d.scatter_(1, idx.long(), val.float())
    d[:, -1] = 0.0
    return d


def eval_logits(ref: Reference, w, question, qlen, feats, boxes):
    """Eval logits with the pad answer excluded (-inf)."""
    with torch.no_grad():
        logits = ref.forward(w, question, qlen, feats, boxes)
    logits[:, -1] = float("-inf")
    return logits
