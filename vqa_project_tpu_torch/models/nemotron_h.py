"""Nemotron-H's hybrid decoder over VQA v2 region tokens, as torch modules.

NVIDIA-Nemotron-3-Nano-30B-A3B (``nemotron_h``, huggingface.co/nvidia/
NVIDIA-Nemotron-3-Nano-30B-A3B-BF16 ``config.json``): blocks of three
kinds in the order of ``hybrid_override_pattern`` (M: Mamba-2, E:
mixture of experts, *: attention), each ``h = h + mixer(RMSNorm(h))``
(eps ``layer_norm_epsilon``), ``norm_f`` after the last. Under the
source's parameter names: ``backbone.embeddings``,
``backbone.layers.{i}.norm`` and ``.mixer.*``, ``backbone.norm_f``.

- **M**, the Mamba-2 mixer (H heads of P, d_inner = H P, state N, G
  groups, conv kernel W with bias, chunk Q):
  ``in_proj`` (no bias) maps the hidden width to [z d_inner | xBC
  d_inner + 2 G N | dt H]; xBC = silu(causal depthwise conv1d(xBC));
  x, B, C = split(xBC); dt = softplus(dt + dt_bias), A = -exp(A_log),
  one of each per head; per head the state S (P, N) runs
  S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T, y_t = S_t C_t + D x_t,
  B and C shared by the H / G heads of a group (``ops/ssd.py``, the
  chunked form); y = RMSNorm over G groups of d_inner / G of (y silu(z))
  times ``norm.weight``; ``out_proj`` (no bias) back to the hidden width.
- **E**, the MoE: float32 router logits over all E routed experts, s =
  sigmoid(x W_r^T); the top k of s + ``e_score_correction_bias``; the
  weights are the chosen s over their sum times ``routed_scaling_factor``
  (``ops/moe.py::route``). Each expert is down(relu(up(x))^2), no gate;
  one shared expert of the same form is added for every token. The held
  experts' weights are stacked, ``mixer.experts.up_proj`` (held, I,
  hidden) and ``.down_proj`` (held, hidden, I): expert j's slice is the
  source's ``mixer.experts.{j}.up_proj.weight``.
- **\\***, attention: grouped-query, ``num_attention_heads`` query heads
  and ``num_key_value_heads`` key/value heads of ``head_dim``, causal,
  scale 1 / sqrt(head_dim), no biases.

The cut of a deployment (``ModelConfig.arch_sizes``): the first
``num_hidden_layers`` blocks of the pattern; the experts
``first_held_expert`` .. + ``n_held_experts`` - 1 held here, the router
keeping all ``n_routed_experts`` outputs and its top k; what the absent
experts would add comes from the cards that hold them and is left out
(``ops/moe.py``).

The VQA model around it:

- the input is each image's live regions through a LLaVA-style
  projector (``multi_modal_projector``: Linear(regions, hidden), GELU,
  Linear(hidden, hidden)), then the question's tokens through
  ``backbone.embeddings``, the whole sequence left-padded to n_obj +
  max_qlen positions;
- ``norm_f`` of the last position goes to ``classifier``,
  Linear(hidden, out_dim - 1), no bias: the answers without the port's
  pad slot; the loss is MCAN's summed BCE (``ops.losses.bce_sum_loss``).

Padding rule: in every Mamba block the pre-conv xBC is zero at pad
positions and dt is 0 there, so the state passes unchanged; attention
masks pad keys; pad tokens are routed to no expert. A padded sequence
thus gives the unpadded sequence's result at its live positions.

Departures from the source, each the benchmark's choice: region features
and a projector stand in for the vision-language model's vision tower;
a classifier over 3,129 answers on the last position stands in for the
language-model head and generated answers; ``e_score_correction_bias``
is a fixed buffer (0) while fine-tuning; the attention blocks get no
position encoding.

Numerics follow the port's policy: parameters, the residual stream, the
norms, the conv, the scan's decays and state, the softmax and the
router in float32; every product's operands in the compute dtype with
float32 sums. There is no dropout: the model has none.

Each MoE block keeps its last forward's row counts on the device;
``counters`` gives their sums over the blocks (``moe.routed_rows``: the
live (token, slot) pairs; ``moe.held_rows``: those whose expert is held
here; ``moe.max_expert_rows``: each block's busiest held expert's rows),
which ``train_step`` returns beside the loss and ``window_sums`` records
at its fetch.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vqa_project_tpu_torch.config import (ModelConfig, device_guard,
                                          resolve_device, torch_dtype)
from vqa_project_tpu_torch.data.feature_cache import RegionCache
from vqa_project_tpu_torch.ops.gather_rows import RegionImage
from vqa_project_tpu_torch.ops.losses import bce_sum_loss
from vqa_project_tpu_torch.ops.matmul import Linear, bmm
from vqa_project_tpu_torch.ops.moe import held_experts, route
from vqa_project_tpu_torch.ops.ssd import ssd

# the score of a masked key
MASKED = -1e9
# NVIDIA-Nemotron-3-Nano-30B-A3B's config.json, under its names, with the
# held range of experts (all of them by default)
PUBLISHED = dict(
    hybrid_override_pattern="MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM"
                            "*EMEMEMEME",
    num_hidden_layers=52, mamba_num_heads=64, mamba_head_dim=64,
    ssm_state_size=128, n_groups=8, conv_kernel=4, chunk_size=128,
    time_step_min=0.001, time_step_max=0.1, time_step_floor=1e-4,
    n_routed_experts=128, num_experts_per_tok=6, moe_intermediate_size=1856,
    moe_shared_expert_intermediate_size=3712, routed_scaling_factor=2.5,
    num_attention_heads=32, num_key_value_heads=2, head_dim=128,
    layer_norm_epsilon=1e-5, initializer_range=0.02,
    n_held_experts=128, first_held_expert=0)


def sizes_of(cfg: ModelConfig) -> dict:
    """The published sizes with ``cfg.arch_sizes`` over them; unknown
    keys raise."""
    unknown = set(cfg.arch_sizes) - set(PUBLISHED)
    if unknown:
        raise ValueError(f"unknown nemotron_h sizes: {sorted(unknown)}")
    return {**PUBLISHED, **cfg.arch_sizes}


class RMSNorm(nn.Module):
    def __init__(self, size: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return self.weight * x * torch.rsqrt(
            x.pow(2).mean(-1, keepdim=True) + self.eps)


class GatedRMSNorm(RMSNorm):
    """Mamba-2's output norm: y silu(z), RMS-normalized over each of
    ``groups`` equal groups of its width, times the weight."""

    def __init__(self, size: int, groups: int, eps: float):
        super().__init__(size, eps)
        self.groups = groups

    def forward(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        g = (y * F.silu(z)).unflatten(-1, (self.groups, -1))
        g = g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + self.eps)
        return g.flatten(-2) * self.weight


class Mamba2Mixer(nn.Module):
    def __init__(self, hid: int, s: dict, cdt: torch.dtype):
        super().__init__()
        self.nh, self.p = s["mamba_num_heads"], s["mamba_head_dim"]
        self.g, self.n = s["n_groups"], s["ssm_state_size"]
        self.inner = self.nh * self.p
        self.conv_dim = self.inner + 2 * self.g * self.n
        self.chunk, self.cdt = s["chunk_size"], cdt
        self.in_proj = Linear(hid, self.inner + self.conv_dim + self.nh, cdt,
                              bias=False)
        self.conv1d = nn.Conv1d(self.conv_dim, self.conv_dim,
                                s["conv_kernel"], groups=self.conv_dim,
                                padding=s["conv_kernel"] - 1)
        self.dt_bias = nn.Parameter(torch.empty(self.nh))
        self.A_log = nn.Parameter(torch.empty(self.nh))
        self.D = nn.Parameter(torch.empty(self.nh))
        self.norm = GatedRMSNorm(self.inner, self.g, s["layer_norm_epsilon"])
        self.out_proj = Linear(self.inner, hid, cdt, bias=False)

    def conv(self, x: torch.Tensor) -> torch.Tensor:
        """The causal depthwise conv over positions of x (b, L, C) f32, as
        its W shifted multiply-adds (elementwise, graph-friendly)."""
        w = self.conv1d.weight[:, 0]                       # (C, W)
        width, length = w.shape[1], x.shape[1]
        xp = F.pad(x, (0, 0, width - 1, 0))
        y = self.conv1d.bias
        for j in range(width):
            y = y + xp[:, j:j + length] * w[:, j]
        return y

    def forward(self, h: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
        b, length, _ = h.shape
        z, xbc, dt = self.in_proj(h).split(
            [self.inner, self.conv_dim, self.nh], dim=-1)
        xbc = F.silu(self.conv(torch.where(live[..., None], xbc, 0.0)))
        x, bm, cm = xbc.split([self.inner, self.g * self.n,
                               self.g * self.n], dim=-1)
        dt = torch.where(live[..., None], F.softplus(dt + self.dt_bias), 0.0)
        y = ssd(x.view(b, length, self.nh, self.p), dt, -torch.exp(self.A_log),
                bm.view(b, length, self.g, self.n),
                cm.view(b, length, self.g, self.n), self.chunk, self.cdt)
        y = y + self.D[:, None] * x.view(b, length, self.nh, self.p)
        return self.out_proj(self.norm(y.reshape(b, length, self.inner), z))


class Attention(nn.Module):
    def __init__(self, hid: int, s: dict, cdt: torch.dtype):
        super().__init__()
        self.nq, self.nkv = s["num_attention_heads"], s["num_key_value_heads"]
        self.d = s["head_dim"]
        self.cdt = cdt
        self.q_proj = Linear(hid, self.nq * self.d, cdt, cdt, bias=False)
        self.k_proj = Linear(hid, self.nkv * self.d, cdt, cdt, bias=False)
        self.v_proj = Linear(hid, self.nkv * self.d, cdt, cdt, bias=False)
        self.o_proj = Linear(self.nq * self.d, hid, cdt, bias=False)

    def forward(self, h: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
        b, length, _ = h.shape
        kv, rep, d = self.nkv, self.nq // self.nkv, self.d
        # query head kv * rep + r reads key/value head kv
        q = self.q_proj(h).view(b, length, kv, rep, d).permute(
            0, 2, 3, 1, 4).reshape(b, kv, rep * length, d)
        k = self.k_proj(h).view(b, length, kv, d).transpose(1, 2)
        v = self.v_proj(h).view(b, length, kv, d).transpose(1, 2)
        scores = bmm(q, k.transpose(-2, -1)).view(
            b, kv, rep, length, length) / math.sqrt(d)
        pos = torch.arange(length, device=h.device)
        allowed = (pos[None, :] <= pos[:, None])[None] & live[:, None, :]
        scores = scores.masked_fill(~allowed[:, None, None], MASKED)
        att = torch.softmax(scores, dim=-1).view(b, kv, rep * length, length)
        out = bmm(att.to(self.cdt), v, self.cdt).view(b, kv, rep, length, d)
        return self.o_proj(out.permute(0, 3, 1, 2, 4).reshape(
            b, length, self.nq * d))


class TopkRouter(nn.Module):
    def __init__(self, hid: int, s: dict):
        super().__init__()
        self.top_k = s["num_experts_per_tok"]
        self.scale = s["routed_scaling_factor"]
        self.weight = nn.Parameter(torch.empty(s["n_routed_experts"], hid))
        self.register_buffer("e_score_correction_bias",
                             torch.zeros(s["n_routed_experts"]))

    def forward(self, x: torch.Tensor):
        """(experts (T, k) int64, weights (T, k) f32) of x (T, hidden)."""
        return route(x, self.weight, self.e_score_correction_bias,
                     self.top_k, self.scale)


class MLP(nn.Module):
    """down(relu(up(x))^2), no biases: the shared expert."""

    def __init__(self, hid: int, inner: int, cdt: torch.dtype):
        super().__init__()
        self.up_proj = Linear(hid, inner, cdt, bias=False)
        self.down_proj = Linear(inner, hid, cdt, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(torch.relu(self.up_proj(x)).pow(2))


class Experts(nn.Module):
    """The held routed experts' weights, stacked."""

    def __init__(self, hid: int, s: dict):
        super().__init__()
        held, inner = s["n_held_experts"], s["moe_intermediate_size"]
        self.first = s["first_held_expert"]
        self.up_proj = nn.Parameter(torch.empty(held, inner, hid))
        self.down_proj = nn.Parameter(torch.empty(held, hid, inner))


class MoE(nn.Module):
    def __init__(self, hid: int, s: dict, cdt: torch.dtype):
        super().__init__()
        if not (0 <= s["first_held_expert"] and s["first_held_expert"]
                + s["n_held_experts"] <= s["n_routed_experts"]):
            raise ValueError("the held experts lie outside the router's")
        self.gate = TopkRouter(hid, s)
        self.experts = Experts(hid, s)
        self.shared_experts = MLP(
            hid, s["moe_shared_expert_intermediate_size"], cdt)
        self.cdt = cdt
        self.rows: Optional[torch.Tensor] = None

    def forward(self, h: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
        b, length, hid = h.shape
        x = h.reshape(b * length, hid)
        idx, w = self.gate(x)
        flat_live = live.reshape(-1)
        routed, counts = held_experts(
            x, idx, w, flat_live, self.experts.up_proj,
            self.experts.down_proj, self.experts.first, self.cdt)
        held = counts[:-1]
        # (live pairs, held pairs, the busiest held expert's pairs)
        self.rows = torch.stack([flat_live.sum().float() * idx.shape[1],
                                 held.sum().float(), held.max().float()])
        return (routed + self.shared_experts(x)).view(b, length, hid)


class Block(nn.Module):
    def __init__(self, kind: str, hid: int, s: dict, cdt: torch.dtype):
        super().__init__()
        self.kind = kind
        self.norm = RMSNorm(hid, s["layer_norm_epsilon"])
        self.mixer = {"M": Mamba2Mixer, "E": MoE,
                      "*": Attention}[kind](hid, s, cdt)

    def forward(self, h: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
        return h + self.mixer(self.norm(h), live)


class Backbone(nn.Module):
    def __init__(self, cfg: ModelConfig, s: dict, cdt: torch.dtype):
        super().__init__()
        pattern = s["hybrid_override_pattern"][:s["num_hidden_layers"]]
        if len(pattern) != s["num_hidden_layers"] or set(pattern) - set("ME*"):
            raise ValueError(f"pattern {pattern!r} for "
                             f"{s['num_hidden_layers']} blocks")
        self.embeddings = nn.Embedding(cfg.vocab_size, cfg.hid_dim)
        self.layers = nn.ModuleList(Block(k, cfg.hid_dim, s, cdt)
                                    for k in pattern)
        self.norm_f = RMSNorm(cfg.hid_dim, s["layer_norm_epsilon"])


class MultiModalProjector(nn.Module):
    def __init__(self, n_in: int, hid: int, cdt: torch.dtype):
        super().__init__()
        self.linear_1 = Linear(n_in, hid, cdt)
        self.linear_2 = Linear(hid, hid, cdt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.gelu(self.linear_1(x)))


def dt_bias_init(n: int, s: dict, g: torch.Generator) -> torch.Tensor:
    """Mamba-2's dt_bias: the inverse softplus of dt drawn log-uniform on
    [time_step_min, time_step_max], floored at time_step_floor."""
    lo, hi = math.log(s["time_step_min"]), math.log(s["time_step_max"])
    dt = torch.exp(torch.rand(n, generator=g) * (hi - lo) + lo).clamp(
        min=s["time_step_floor"])
    return dt + torch.log(-torch.expm1(-dt))


class NemotronHModel(nn.Module):
    """The decoder's VQA forward with ``GraphVQAModel``'s call and return:
    ``forward(question (B, T) int, image, qlen (B,), *, train, generator)``
    -> (logits (B, out_dim - 1) f32, None, None). ``image`` is a
    ``RegionImage`` (the device table's gather), a (features (B, K, F),
    boxes) pair or a dense (B, K, F + 4) feat||bbox tensor (host mode),
    whose live regions are its first rows: ``count`` of them, or those
    whose features are not all zero. A question's live tokens are its
    nonzero ids, first. ``cfg.hid_dim`` is the hidden width (the
    embedding's too: ``cfg.emb_dim`` is not read), ``cfg.feat_dim - 4``
    the regions' width; ``cfg.arch_sizes`` the rest (``PUBLISHED``)."""

    pad_logit = False
    feature_cache = RegionCache
    # the tokens a question keeps: MCAN's MAX_TOKEN, so that the sequence
    # is the 100 regions and 14 tokens
    MAX_QLEN = 14

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        if cfg.quantized_inference or cfg.merged_block:
            raise ValueError("nemotron_h has no int8 serving path nor "
                             "merged graph block")
        self.cfg = cfg
        self.sizes = sizes_of(cfg)
        cdt = torch_dtype(cfg.compute_dtype)
        self.compute_dtype = cdt
        self.multi_modal_projector = MultiModalProjector(cfg.feat_dim - 4,
                                                         cfg.hid_dim, cdt)
        self.backbone = Backbone(cfg, self.sizes, cdt)
        self.classifier = Linear(cfg.hid_dim, cfg.out_dim - 1, cdt,
                                 bias=False)
        if dev.type != "meta":
            # on the meta device (built to count, or to be filled by
            # ``to_empty`` and ``load_state_dict``) there is nothing to draw
            self.reset_parameters(seed)
        self.to(dev)

    @property
    def word_embedding(self) -> None:
        """None: the backbone's own embedding table is of the hidden
        width, which a dataset's word vectors do not fill."""
        return None

    def reset_parameters(self, seed: int) -> None:
        """Nemotron-H's initialization: every Linear, the embedding and
        the router N(0, initializer_range), biases 0; each Mamba mixer's
        A_log = log(1..H), D = 1, dt_bias by ``dt_bias_init``, its conv
        torch's default U(-1/sqrt(W), 1/sqrt(W)) and its out_proj
        kaiming-uniform over sqrt(num_hidden_layers)
        (``rescale_prenorm_residual``); every norm 1."""
        s = self.sizes
        std = s["initializer_range"]
        g = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, Linear):
                    mod.weight.normal_(0.0, std, generator=g)
                    if mod.bias is not None:
                        mod.bias.zero_()
                elif isinstance(mod, (TopkRouter, nn.Embedding)):
                    mod.weight.normal_(0.0, std, generator=g)
                elif isinstance(mod, Experts):
                    mod.up_proj.normal_(0.0, std, generator=g)
                    mod.down_proj.normal_(0.0, std, generator=g)
                elif isinstance(mod, RMSNorm):
                    mod.weight.fill_(1.0)
            for mod in self.modules():
                if isinstance(mod, Mamba2Mixer):
                    mod.A_log.copy_(torch.log(torch.arange(
                        1, mod.nh + 1, dtype=torch.float32)))
                    mod.D.fill_(1.0)
                    mod.dt_bias.copy_(dt_bias_init(mod.nh, s, g))
                    bound = 1.0 / math.sqrt(mod.conv1d.weight.shape[-1])
                    mod.conv1d.weight.uniform_(-bound, bound, generator=g)
                    mod.conv1d.bias.uniform_(-bound, bound, generator=g)
                    w = mod.out_proj.weight
                    bound = 1.0 / math.sqrt(w.shape[1])
                    w.uniform_(-bound, bound, generator=g)
                    w.div_(math.sqrt(s["num_hidden_layers"]))

    def regions(self, image):
        """(features (B, K, F), live region mask (B, K) bool)."""
        if isinstance(image, RegionImage):
            feats, count = image
            pos = torch.arange(feats.shape[1], device=feats.device)
            return feats, pos[None, :] < count[:, None]
        feats = (image[0] if isinstance(image, (tuple, list))
                 else image[..., :self.cfg.feat_dim - 4])
        return feats, feats.float().abs().sum(-1) != 0

    def sequence(self, question: torch.Tensor, image):
        """(h (B, K + T, hidden) f32, live (B, K + T) bool): each row's
        live regions then its live tokens, left-padded (pad rows 0)."""
        feats, region_live = self.regions(image)
        k, t = feats.shape[1], question.shape[1]
        length = k + t
        n_r = region_live.sum(-1)
        n_q = (question != 0).sum(-1)
        src = torch.cat([self.multi_modal_projector(feats),
                         F.embedding(question.long(),
                                     self.backbone.embeddings.weight)], 1)
        pos = torch.arange(length, device=question.device)[None, :]
        j = pos - (length - n_r - n_q)[:, None]       # index among the live
        live = j >= 0
        at = torch.where(j < n_r[:, None], j, k + j - n_r[:, None])
        at = torch.where(live, at, torch.zeros_like(at))
        h = torch.gather(src, 1, at[..., None].expand(-1, -1, src.shape[-1]))
        return torch.where(live[..., None], h, 0.0), live

    def forward(self, question: torch.Tensor, image, qlen: torch.Tensor, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        """Eval (the default) runs under ``torch.no_grad``; ``train=True``
        records the graph for backward. ``qlen`` and ``generator`` are not
        read (the model draws no dropout)."""
        del qlen, generator
        with device_guard(question.device):
            if not train:
                with torch.no_grad():
                    return self._forward(question, image)
            return self._forward(question, image)

    def _forward(self, question, image):
        h, live = self.sequence(question, image)
        for layer in self.backbone.layers:
            h = layer(h, live)
        return self.classifier(self.backbone.norm_f(h[:, -1])), None, None

    def counters(self) -> Dict[str, torch.Tensor]:
        """The last forward's MoE row counts summed over its blocks, 0-d
        float32 on the device (see the module's docstring)."""
        rows = [layer.mixer.rows for layer in self.backbone.layers
                if layer.kind == "E" and layer.mixer.rows is not None]
        if not rows:
            return {}
        total = torch.stack(rows).sum(0)
        return {"moe.routed_rows": total[0], "moe.held_rows": total[1],
                "moe.max_expert_rows": total[2]}

    @staticmethod
    def loss(logits: torch.Tensor, targets: torch.Tensor,
             sample_mask: Optional[torch.Tensor] = None,
             count: Optional[torch.Tensor] = None) -> torch.Tensor:
        """MCAN's summed BCE (``ops.losses.bce_sum_loss``); the labels'
        pad column, past the logits, is left out."""
        del count
        return bce_sum_loss(logits, targets[:, :logits.shape[1]],
                            sample_mask)
