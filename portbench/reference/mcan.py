"""The plain reference of MCAN (MCA-ED), in float32.

Written from Yu et al., "Deep Modular Co-Attention Networks for Visual
Question Answering" (CVPR 2019, arXiv:1906.10770) and the published
code's conventions (github.com/MILVLG/mcan-vqa, ``core/model/net.py``,
``core/model/mca.py``, ``core/model/net_utils.py``), with plain torch
operations on a dict of weights under that code's state_dict names;
nothing of the program under test is imported.

    Y = LSTM(embed(question)) over all T positions       (B, T, H)
    X = img_feat_linear(feats)                           (B, K, H)
    SA  x L on Y: Y = LN(Y + drop(MHA(Y, Y, Y))); Y = LN(Y + drop(FFN(Y)))
    SGA x L on X: X = LN(X + drop(MHA(X, X, X))); X = LN(X + drop(MHA(X, Y, Y)));
                  X = LN(X + drop(FFN(X)))
    logits = proj(LN(AttFlat_lang(Y) + AttFlat_img(X)))

Masks are MCAN's own: a token is padding where its id is 0, a region
where its features sum to 0 in absolute value; a masked key's score
(and a masked position's AttFlat weight) is -1e9 before the softmax.
LN is a (x - mean) / (std + 1e-6) + b with the unbiased std. The loss
is the BCE of sigmoid(logits) against the soft labels, summed over the
batch and the answers (MCAN's ``BCELoss(reduction="sum")``, written as
y softplus(-x) + (1 - y) softplus(x)).

Departures from the published recipe, each one of the benchmark's
choices: the program computes its products in bfloat16 (this file in
float32, TF32 off); the steps use Adam with beta 0.9 / 0.999 and eps
1e-8, the port's (MCAN: 0.9 / 0.98, 1e-9); MCAN's learning-rate warm-up
over its first 3 epochs and its decay at epochs 10 and 12 lie far
outside a 30 s window and are left out.

Dropout draws one uniform per element from the step's generator, kept
where u >= rate and scaled by 1 / (1 - rate), in this order: each SA
layer's attention probabilities, attention output, FFN hidden layer and
FFN output; each SGA layer's self-attention probabilities and output,
guided-attention probabilities and output, FFN hidden layer and FFN
output; AttFlat of the question's MLP hidden layer, then the image's.

``precision="fp8"`` rounds both operands of every product to float8
e4m3 with a per-tensor scale (sums stay float32): the control that a
computation one precision below the configured bfloat16 must fail.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.reference.adam import adam_steps
from portbench.reference.model import _fp8

MASKED = -1e9


class MCANReference:
    """The forward and loss at a configuration's widths (its ``model``
    section: mcan-vqa's names in lower case)."""

    def __init__(self, m: dict, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)
        self.m = m
        self.q = _fp8 if precision == "fp8" else (lambda t: t)

    def mm(self, a, b):
        return torch.matmul(self.q(a), self.q(b))

    def linear(self, w, name, x):
        return self.mm(x, w[f"{name}.weight"].t()) + w[f"{name}.bias"]

    @staticmethod
    def norm(w, name, x):
        mean = x.mean(-1, keepdim=True)
        std = x.std(-1, keepdim=True)
        return w[f"{name}.a_2"] * (x - mean) / (std + 1e-6) + w[f"{name}.b_2"]

    def lstm(self, w, emb):
        hid = w["lstm.weight_hh_l0"].shape[1]
        xp = (self.mm(emb, w["lstm.weight_ih_l0"].t())
              + w["lstm.bias_ih_l0"] + w["lstm.bias_hh_l0"])
        h = emb.new_zeros((emb.shape[0], hid))
        c = emb.new_zeros((emb.shape[0], hid))
        out = []
        for t in range(emb.shape[1]):
            g = xp[:, t] + self.mm(h, w["lstm.weight_hh_l0"].t())
            i, f, gg, o = g.split(hid, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        return torch.stack(out, dim=1)

    def mlp(self, w, name, x, drop):
        return self.linear(w, f"{name}.linear",
                           drop(torch.relu(self.linear(w, f"{name}.fc.linear",
                                                       x))))

    def mha(self, w, name, v, k, q, mask, drop):
        b, lq, hid = q.shape
        nh = self.m["multi_head"]
        d = hid // nh

        def heads(t, part):
            return self.linear(w, f"{name}.linear_{part}", t).view(
                b, -1, nh, d).transpose(1, 2)

        v, k, q = heads(v, "v"), heads(k, "k"), heads(q, "q")
        scores = self.mm(q, k.transpose(-2, -1)) / math.sqrt(d)
        scores = scores.masked_fill(mask[:, None, None, :], MASKED)
        att = drop(torch.softmax(scores, dim=-1))
        out = self.mm(att, v).transpose(1, 2).reshape(b, lq, hid)
        return self.linear(w, f"{name}.linear_merge", out)

    def attflat(self, w, name, x, mask, drop):
        att = self.mlp(w, f"{name}.mlp", x, drop)
        att = torch.softmax(att.masked_fill(mask[:, :, None], MASKED), dim=1)
        flat = torch.cat([torch.sum(att[:, :, i:i + 1] * x, dim=1)
                          for i in range(self.m["flat_glimpses"])], dim=1)
        return self.linear(w, f"{name}.linear_merge", flat)

    def forward(self, w: Dict[str, torch.Tensor], question, feats,
                generator: Optional[torch.Generator] = None):
        """logits (B, answer_size) float32; ``feats`` (B, K, F) float32
        with each image's padding rows zero; ``generator`` draws a
        training step's dropout (None: eval)."""
        rate = self.m["dropout_r"] if generator is not None else 0.0

        def drop(x):
            if rate <= 0:
                return x
            u = torch.rand(x.shape, generator=generator, device=x.device)
            return torch.where(u >= rate, x / (1.0 - rate),
                               torch.zeros_like(x))

        token_pad = question == 0
        region_pad = feats.abs().sum(-1) == 0
        y = self.lstm(w, w["embedding.weight"][question.long()])
        x = self.linear(w, "img_feat_linear", feats)
        for i in range(self.m["layer"]):
            p = f"backbone.enc_list.{i}"
            y = self.norm(w, f"{p}.norm1", y + drop(self.mha(
                w, f"{p}.mhatt", y, y, y, token_pad, drop)))
            y = self.norm(w, f"{p}.norm2", y + drop(self.mlp(
                w, f"{p}.ffn.mlp", y, drop)))
        for i in range(self.m["layer"]):
            p = f"backbone.dec_list.{i}"
            x = self.norm(w, f"{p}.norm1", x + drop(self.mha(
                w, f"{p}.mhatt1", x, x, x, region_pad, drop)))
            x = self.norm(w, f"{p}.norm2", x + drop(self.mha(
                w, f"{p}.mhatt2", y, y, x, token_pad, drop)))
            x = self.norm(w, f"{p}.norm3", x + drop(self.mlp(
                w, f"{p}.ffn.mlp", x, drop)))
        flat = (self.attflat(w, "attflat_lang", y, token_pad, drop)
                + self.attflat(w, "attflat_img", x, region_pad, drop))
        return self.linear(w, "proj", self.norm(w, "proj_norm", flat))


def bce_sum(logits, targets, mask):
    """The BCE of sigmoid(logits) against ``targets`` summed over the
    answers and the rows whose mask is > 0."""
    per = (targets * F.softplus(-logits)
           + (1 - targets) * F.softplus(logits)).sum(-1)
    return torch.where(mask > 0, per, torch.zeros_like(per)).sum()


def run_steps(ref: MCANReference, w0: Dict[str, torch.Tensor],
              batches: List[dict], lr: float, gen_seed: int, device):
    """Train ``len(batches)`` steps from ``w0`` with dropout from one
    generator seeded ``gen_seed`` on ``device``; each batch holds
    question, feats, answers (dense, answer_size wide) and mask. Returns
    ``adam_steps``'s (losses, first gradients, change, first logits)."""
    gen = torch.Generator(device=device).manual_seed(int(gen_seed))

    def loss_of(w, bt):
        logits = ref.forward(w, bt["question"], bt["feats"], gen)
        return bce_sum(logits, bt["answers"], bt["mask"]), logits

    return adam_steps(loss_of, w0, batches, lr)
