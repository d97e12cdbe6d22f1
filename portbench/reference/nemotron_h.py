"""The plain reference of Nemotron-H's hybrid decoder over region tokens,
in float32.

Written from NVIDIA-Nemotron-3-Nano-30B-A3B's ``config.json``
(``nemotron_h``) and Mamba-2 (Dao and Gu, arXiv:2405.21060), with plain
torch operations on a dict of weights under the program's state_dict
names; nothing of the program under test is imported. Each block is
h = h + mixer(RMSNorm(h)), eps ``layer_norm_epsilon``, in the order of
the pattern's first ``num_hidden_layers`` letters:

- M: zxbcdt = h W_in^T; xBC = silu(causal depthwise conv1d(xBC) + bias);
  dt = softplus(dt + dt_bias), A = -exp(A_log); per head the state runs
  position by position, S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,
  y_t = S_t C_t + D x_t, heads h of group h // (H / G); y = RMSNorm over
  G groups of (y silu(z)) times the norm's weight; out = y W_out^T.
- E: s = sigmoid(h W_r^T) over ``router_experts``; the top k of s + the
  correction bias; weights the chosen s over their sum (+ 1e-20) times
  ``routed_scaling_factor``; out = shared(h) + the sum, over the held
  experts in a plain loop, of each routed token's weight times
  down(relu(up(h))^2) (the held experts' part only, as the program).
- *: grouped-query attention, causal, 1 / sqrt(head_dim), no biases.

The sequence is each image's live regions through the projector
(Linear, GELU, Linear) then the question's live tokens through the
embedding, unpadded: every sequence starts at position 0, and a batch of
them runs side by side with the shorter ones' tails past their ends.
Every operation is causal or per position, so a tail never reaches a
sequence's live positions, and no mask is needed; each sequence's
logits are the classifier of ``norm_f`` at its own last position. The
loss is the BCE of sigmoid(logits) summed over the rows and answers.

``precision="fp8"`` rounds both operands of every product that the
program computes in bfloat16 to float8 e4m3 with a per-tensor scale
(the router's float32 product stays float32; sums stay float32): the
control that a computation one precision below the configured bfloat16
must fail.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.reference.adam import adam_steps
from portbench.reference.mcan import bce_sum
from portbench.reference.model import _fp8


class NemotronHReference:
    """The forward at the widths of ``harness/nemotron.py::spec``."""

    def __init__(self, m: dict, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)
        self.m = m
        self.q = _fp8 if precision == "fp8" else (lambda t: t)
        self.kinds = m["hybrid_override_pattern"][:m["num_hidden_layers"]]

    def mm(self, a, b):
        return torch.matmul(self.q(a), self.q(b))

    def linear(self, w, name, x):
        y = self.mm(x, w[f"{name}.weight"].t())
        bias = w.get(f"{name}.bias")
        return y if bias is None else y + bias

    def rms(self, x, weight):
        return weight * x * torch.rsqrt(
            x.pow(2).mean(-1, keepdim=True) + self.m["layer_norm_epsilon"])

    def mamba(self, w, p, x):
        m = self.m
        b, length, _ = x.shape
        nh, hp = m["mamba_num_heads"], m["mamba_head_dim"]
        g, n = m["n_groups"], m["ssm_state_size"]
        inner = nh * hp
        z, xbc, dt = self.linear(w, f"{p}.in_proj", x).split(
            [inner, inner + 2 * g * n, nh], dim=-1)
        width = m["conv_kernel"]
        xbc = F.conv1d(xbc.transpose(1, 2), w[f"{p}.conv1d.weight"],
                       w[f"{p}.conv1d.bias"], padding=width - 1,
                       groups=xbc.shape[-1])[..., :length].transpose(1, 2)
        xs, bm, cm = F.silu(xbc).split([inner, g * n, g * n], dim=-1)
        dt = F.softplus(dt + w[f"{p}.dt_bias"])
        a = -torch.exp(w[f"{p}.A_log"])
        xs = xs.reshape(b, length, nh, hp)
        bh = bm.reshape(b, length, g, n).repeat_interleave(nh // g, dim=2)
        ch = cm.reshape(b, length, g, n).repeat_interleave(nh // g, dim=2)
        state = x.new_zeros((b, nh, hp, n))
        ys = []
        for t in range(length):
            du = self.q(dt[:, t, :, None] * xs[:, t])
            state = (torch.exp(dt[:, t] * a)[..., None, None] * state
                     + du[..., None] * self.q(bh[:, t])[:, :, None, :])
            ys.append(torch.einsum("bhpn,bhn->bhp", self.q(state),
                                   self.q(ch[:, t])))
        y = torch.stack(ys, dim=1) + w[f"{p}.D"][:, None] * xs
        gated = (y.reshape(b, length, inner) * F.silu(z)).reshape(
            b, length, g, inner // g)
        gated = gated * torch.rsqrt(gated.pow(2).mean(-1, keepdim=True)
                                    + m["layer_norm_epsilon"])
        y = gated.reshape(b, length, inner) * w[f"{p}.norm.weight"]
        return self.mm(y, w[f"{p}.out_proj.weight"].t())

    def attention(self, w, p, x):
        m = self.m
        b, length, _ = x.shape
        nq, nkv, d = (m["num_attention_heads"], m["num_key_value_heads"],
                      m["head_dim"])

        def heads(name, count):
            return self.linear(w, f"{p}.{name}", x).view(
                b, length, count, d).transpose(1, 2)

        q = heads("q_proj", nq)
        k = heads("k_proj", nkv).repeat_interleave(nq // nkv, dim=1)
        v = heads("v_proj", nkv).repeat_interleave(nq // nkv, dim=1)
        scores = self.mm(q, k.transpose(-2, -1)) / math.sqrt(d)
        future = torch.ones(length, length, dtype=torch.bool,
                            device=x.device).triu(1)
        att = torch.softmax(scores.masked_fill(future, float("-inf")), -1)
        out = self.mm(att, v).transpose(1, 2).reshape(b, length, nq * d)
        return self.linear(w, f"{p}.o_proj", out)

    def relu2(self, x, up, down):
        return self.mm(torch.relu(self.mm(x, up.t())).pow(2), down.t())

    def moe(self, w, p, x):
        """(out, the chosen experts (b, L, k))."""
        m = self.m
        scores = torch.sigmoid(x @ w[f"{p}.gate.weight"].t())
        bias = w[f"{p}.gate.e_score_correction_bias"]
        idx = torch.topk(scores.detach() + bias, m["num_experts_per_tok"],
                         dim=-1)[1]
        wt = scores.gather(-1, idx)
        wt = wt / (wt.sum(-1, keepdim=True) + 1e-20) \
            * m["routed_scaling_factor"]
        out = self.relu2(x, w[f"{p}.shared_experts.up_proj.weight"],
                         w[f"{p}.shared_experts.down_proj.weight"])
        up, down = w[f"{p}.experts.up_proj"], w[f"{p}.experts.down_proj"]
        for e in range(up.shape[0]):
            hit = idx == m["first_held_expert"] + e
            tok = hit.any(-1)
            if bool(tok.any()):
                weight = (wt * hit).sum(-1)[tok]
                out = out.index_put((tok,), out[tok] + weight[:, None]
                                    * self.relu2(x[tok], up[e], down[e]))
        return out, idx

    def forward(self, w: Dict[str, torch.Tensor], question, feats, counts):
        """(logits (B, answer_size), the chosen experts of each MoE block
        (B, L, k) with L the longest sequence) for questions (B, T) whose
        live tokens are their nonzero ids, first, and images' features
        (B, K, F) of which the first ``counts`` (B,) rows are live."""
        n_q = (question != 0).sum(-1)
        n = counts + n_q
        length = int(n.max())
        regions = self.linear(w, "multi_modal_projector.linear_2", F.gelu(
            self.linear(w, "multi_modal_projector.linear_1", feats)))
        tokens = w["backbone.embeddings.weight"][question.long()]
        pos = torch.arange(length, device=question.device)[None, :]
        k = feats.shape[1]
        at = torch.where(pos < counts[:, None], pos,
                         k + pos - counts[:, None]).clamp(
                             max=k + question.shape[1] - 1)
        src = torch.cat([regions, tokens], dim=1)
        h = torch.gather(src, 1, at[..., None].expand(-1, -1, src.shape[-1]))
        routes: List[torch.Tensor] = []
        for i, kind in enumerate(self.kinds):
            p = f"backbone.layers.{i}"
            x = self.rms(h, w[f"{p}.norm.weight"])
            if kind == "M":
                h = h + self.mamba(w, f"{p}.mixer", x)
            elif kind == "*":
                h = h + self.attention(w, f"{p}.mixer", x)
            else:
                out, idx = self.moe(w, f"{p}.mixer", x)
                h = h + out
                routes.append(idx)
        last = h[torch.arange(h.shape[0], device=h.device), n - 1]
        return (self.mm(self.rms(last, w["backbone.norm_f.weight"]),
                        w["classifier.weight"].t()), routes)


def route_mismatch(program: List[torch.Tensor],
                   reference: List[List[torch.Tensor]], n) -> float:
    """The share of the live (token, slot) choices, over the MoE blocks,
    in which the program's top k holds an expert that the reference's
    lacks. ``program``: each block's (B, P, k) over its left-padded P
    positions; ``reference``: each block's list of the B sequences' (n_i,
    k) from position 0; ``n`` (B,) the sequences' lengths."""
    missed, total = 0, 0
    for prog, ref in zip(program, reference):
        b, p, k = prog.shape
        for i in range(b):
            mine = prog[i, p - int(n[i]):]
            hit = (mine[:, :, None] == ref[i][:, None, :]).any(-1)
            missed += int((~hit).sum())
            total += hit.numel()
    if len(program) != len(reference) or total == 0:
        return math.inf
    return missed / total


def run_steps(ref: NemotronHReference, w0: Dict[str, torch.Tensor],
              batches: List[dict], lr: float, rows_at_once: int):
    """Train ``len(batches)`` steps from ``w0`` with ``adam_steps``; each
    batch holds question, feats, counts, answers (dense, answer_size
    wide) and mask. A step's gradient is summed over parts of
    ``rows_at_once`` rows (the loss is a sum over rows), handed to
    ``adam_steps`` as the gradient of a loss of the same value. Returns
    ``adam_steps``'s (losses, first gradients, change, first logits) and
    the first step's chosen experts of every MoE block, each a list of
    the sequences' (n_i, k) (``route_mismatch``'s ``reference``)."""
    first_routes: List[List[torch.Tensor]] = []

    def loss_of(w, bt):
        names = list(w)
        grads = {k: torch.zeros_like(v) for k, v in w.items()}
        total, logits, routes = 0.0, [], []
        rows = bt["question"].shape[0]
        for s in range(0, rows, rows_at_once):
            part = slice(s, s + rows_at_once)
            lg, rt = ref.forward(w, bt["question"][part], bt["feats"][part],
                                 bt["counts"][part])
            loss = bce_sum(lg, bt["answers"][part], bt["mask"][part])
            parts = torch.autograd.grad(loss, [w[k] for k in names],
                                        allow_unused=True)
            for k, g in zip(names, parts):
                if g is not None:
                    grads[k] += g
            total = total + loss.detach()
            logits.append(lg.detach())
            n = (bt["counts"][part] + (bt["question"][part] != 0).sum(-1))
            routes.append([[r[i, :int(n[i])] for i in range(r.shape[0])]
                           for r in rt])
        if not first_routes:
            # each block's list of every sequence's choices
            first_routes.append([sum((part[j] for part in routes), [])
                                 for j in range(len(routes[0]))])
        surrogate = sum((grads[k] * w[k]).sum() for k in names)
        return total + (surrogate - surrogate.detach()), torch.cat(logits)

    out = adam_steps(loss_of, w0, batches, lr)
    return out, first_routes[0]
