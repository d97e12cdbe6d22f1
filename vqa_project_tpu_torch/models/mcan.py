"""MCAN, the deep modular co-attention network, as torch modules.

Yu, Yu, Cui, Tao and Tian, "Deep Modular Co-Attention Networks for
Visual Question Answering" (CVPR 2019, arXiv:1906.10770): the
encoder-decoder MCA-ED of github.com/MILVLG/mcan-vqa
(``core/model/net.py``, ``core/model/mca.py``), under its state_dict
names (``embedding``, ``lstm.*_l0``, ``img_feat_linear``,
``backbone.enc_list.{i}`` / ``backbone.dec_list.{i}``, ``attflat_img``,
``attflat_lang``, ``proj_norm``, ``proj``):

    Y = LSTM(embed(question)), every one of the T positions   (B, T, H)
    X = img_feat_linear(region features)                      (B, K, H)
    SA, N_LAYERS times:   Y = LN(Y + drop(MHA(Y, Y, Y, token mask)))
                          Y = LN(Y + drop(FFN(Y)))
    SGA, N_LAYERS times:  X = LN(X + drop(MHA(X, X, X, region mask)))
                          X = LN(X + drop(MHA(q = X, k = v = Y, token mask)))
                          X = LN(X + drop(FFN(X)))
    logits = proj(proj_norm(AttFlat_lang(Y) + AttFlat_img(X)))

MHA: ``N_HEADS`` heads of H / N_HEADS; separate q, k, v and merge
Linears; softmax(q k^T / sqrt(d)) with the masked keys' scores set to
-1e9, dropout on the probabilities. FFN: Linear(H, 4 H), ReLU, dropout,
Linear(4 H, H). LN is MCAN's: a (x - mean) / (std + 1e-6) + b with the
unbiased std. AttFlat: an MLP (H -> FLAT_MLP -> GLIMPSES; ReLU,
dropout) weighs each position, the masked ones at -1e9, softmax over
the positions, each glimpse's weighted sum concatenated, Linear(H
GLIMPSES, 2 H). ``proj`` has ``out_dim - 1`` outputs: the answers,
without the port's pad slot (the last label column, never a label).

Masks: a token is padding where its id is 0; a region where its row
lies at or past its image's count (a ``RegionImage`` from the device
table) or, for images given dense, where its features sum to 0 in
absolute value, MCAN's own rule. The two agree where an image's zero
rows are its last ones, as padded detector features are.

Numerics follow the port's policy: parameters, the residual stream,
LN, the scores and softmax, the FFN's and AttFlat's hidden layers and
the logits in float32; every product's operands in the compute dtype
with float32 sums, the q, k and v projections and the attention's
output stored in the compute dtype. The LSTM's steps are plain torch
ops, on the CPU and the card alike, so a CUDA graph captures them.

Dropout (train mode, rate ``cfg.dropout``; ``ops.dropout.dropout``, one
uniform of the step's generator per element) draws in this order:

- each SA layer: the attention probabilities (B, h, T, T), the
  attention's output (B, T, H), the FFN's hidden layer (B, T, 4 H), the
  FFN's output (B, T, H);
- each SGA layer: the self-attention's probabilities (B, h, K, K) and
  output (B, K, H), the guided attention's probabilities (B, h, K, T)
  and output (B, K, H), the FFN's hidden layer (B, K, 4 H) and output
  (B, K, H);
- AttFlat of the question, then of the image: the MLP's hidden layer
  (B, T, FLAT_MLP), then (B, K, FLAT_MLP).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vqa_project_tpu_torch.config import (ModelConfig, device_guard,
                                          resolve_device, torch_dtype)
from vqa_project_tpu_torch.data.feature_cache import RegionCache
from vqa_project_tpu_torch.ops.dropout import dropout
from vqa_project_tpu_torch.ops.gather_rows import RegionImage
from vqa_project_tpu_torch.ops.losses import bce_sum_loss
from vqa_project_tpu_torch.ops.matmul import Linear, bmm, matmul

# the score of a masked key or position (MCAN's)
MASKED = -1e9
# the widths that MCAN's published configurations (cfgs/small_model.yml
# and large_model.yml) share; each sets its hidden width H, with the
# FFN's 4 H and AttFlat's output of 2 H
N_HEADS = 8            # MULTI_HEAD
N_LAYERS = 6           # LAYER: SA encoders and SGA decoders
FLAT_MLP = 512         # FLAT_MLP_SIZE
GLIMPSES = 1           # FLAT_GLIMPSES


class LayerNorm(nn.Module):
    """MCAN's layer norm: a (x - mean) / (std + eps) + b, unbiased std."""

    def __init__(self, size: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.a_2 = nn.Parameter(torch.ones(size))
        self.b_2 = nn.Parameter(torch.zeros(size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        std = x.std(-1, keepdim=True)
        return self.a_2 * (x - mean) / (std + self.eps) + self.b_2


class FC(nn.Module):
    def __init__(self, in_size: int, out_size: int, cdt: torch.dtype):
        super().__init__()
        self.linear = Linear(in_size, out_size, cdt)


class MLP(nn.Module):
    """Linear, ReLU, dropout, Linear (mcan-vqa's ``MLP`` of an ``FC``)."""

    def __init__(self, in_size: int, mid_size: int, out_size: int,
                 cdt: torch.dtype):
        super().__init__()
        self.fc = FC(in_size, mid_size, cdt)
        self.linear = Linear(mid_size, out_size, cdt)

    def forward(self, x, rate, generator):
        h = dropout(torch.relu(self.fc.linear(x)), rate, generator)
        return self.linear(h)


class FFN(nn.Module):
    def __init__(self, cfg: ModelConfig, cdt: torch.dtype):
        super().__init__()
        self.mlp = MLP(cfg.hid_dim, 4 * cfg.hid_dim, cfg.hid_dim, cdt)

    def forward(self, x, rate, generator):
        return self.mlp(x, rate, generator)


class MHAtt(nn.Module):
    def __init__(self, cfg: ModelConfig, cdt: torch.dtype):
        super().__init__()
        h = cfg.hid_dim
        if h % N_HEADS:
            raise ValueError(f"hid_dim {h} not divisible by {N_HEADS} "
                             "heads")
        self.compute_dtype = cdt
        self.linear_v = Linear(h, h, cdt, cdt)
        self.linear_k = Linear(h, h, cdt, cdt)
        self.linear_q = Linear(h, h, cdt, cdt)
        self.linear_merge = Linear(h, h, cdt)

    def forward(self, v, k, q, mask, rate, generator):
        """``mask`` (B, Lk) bool: the keys that are padding."""
        b, lq, hid = q.shape
        nh = N_HEADS
        d = hid // nh

        def heads(t):
            return t.view(b, -1, nh, d).transpose(1, 2)

        v = heads(self.linear_v(v))
        k = heads(self.linear_k(k))
        q = heads(self.linear_q(q))
        scores = bmm(q, k.transpose(-2, -1)) / math.sqrt(d)
        scores = scores.masked_fill(mask[:, None, None, :], MASKED)
        att = dropout(torch.softmax(scores, dim=-1), rate, generator)
        out = bmm(att.to(self.compute_dtype), v, self.compute_dtype)
        return self.linear_merge(out.transpose(1, 2).reshape(b, lq, hid))


class SA(nn.Module):
    def __init__(self, cfg: ModelConfig, cdt: torch.dtype):
        super().__init__()
        self.mhatt = MHAtt(cfg, cdt)
        self.ffn = FFN(cfg, cdt)
        self.norm1 = LayerNorm(cfg.hid_dim)
        self.norm2 = LayerNorm(cfg.hid_dim)

    def forward(self, y, y_mask, rate, generator):
        y = self.norm1(y + dropout(
            self.mhatt(y, y, y, y_mask, rate, generator), rate, generator))
        return self.norm2(y + dropout(self.ffn(y, rate, generator), rate,
                                      generator))


class SGA(nn.Module):
    def __init__(self, cfg: ModelConfig, cdt: torch.dtype):
        super().__init__()
        self.mhatt1 = MHAtt(cfg, cdt)
        self.mhatt2 = MHAtt(cfg, cdt)
        self.ffn = FFN(cfg, cdt)
        self.norm1 = LayerNorm(cfg.hid_dim)
        self.norm2 = LayerNorm(cfg.hid_dim)
        self.norm3 = LayerNorm(cfg.hid_dim)

    def forward(self, x, y, x_mask, y_mask, rate, generator):
        x = self.norm1(x + dropout(
            self.mhatt1(x, x, x, x_mask, rate, generator), rate, generator))
        x = self.norm2(x + dropout(
            self.mhatt2(y, y, x, y_mask, rate, generator), rate, generator))
        return self.norm3(x + dropout(self.ffn(x, rate, generator), rate,
                                      generator))


class MCA_ED(nn.Module):
    def __init__(self, cfg: ModelConfig, cdt: torch.dtype):
        super().__init__()
        self.enc_list = nn.ModuleList(SA(cfg, cdt) for _ in range(N_LAYERS))
        self.dec_list = nn.ModuleList(SGA(cfg, cdt) for _ in range(N_LAYERS))

    def forward(self, y, x, y_mask, x_mask, rate, generator):
        for enc in self.enc_list:
            y = enc(y, y_mask, rate, generator)
        for dec in self.dec_list:
            x = dec(x, y, x_mask, y_mask, rate, generator)
        return y, x


class AttFlat(nn.Module):
    def __init__(self, cfg: ModelConfig, cdt: torch.dtype):
        super().__init__()
        self.mlp = MLP(cfg.hid_dim, FLAT_MLP, GLIMPSES, cdt)
        self.linear_merge = Linear(cfg.hid_dim * GLIMPSES, 2 * cfg.hid_dim,
                                   cdt)

    def forward(self, x, mask, rate, generator):
        att = self.mlp(x, rate, generator).masked_fill(mask[:, :, None],
                                                       MASKED)
        att = torch.softmax(att, dim=1)
        flat = torch.cat([torch.sum(att[:, :, i:i + 1] * x, dim=1)
                          for i in range(GLIMPSES)], dim=1)
        return self.linear_merge(flat)


class LSTMWeights(nn.Module):
    """Holder of one LSTM layer's parameters under ``nn.LSTM``'s names
    (gates i, f, g, o); ``MCANModel.encode_question`` runs it."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.weight_ih_l0 = nn.Parameter(torch.empty(4 * hidden_size,
                                                     input_size))
        self.weight_hh_l0 = nn.Parameter(torch.empty(4 * hidden_size,
                                                     hidden_size))
        self.bias_ih_l0 = nn.Parameter(torch.empty(4 * hidden_size))
        self.bias_hh_l0 = nn.Parameter(torch.empty(4 * hidden_size))


class MCANModel(nn.Module):
    """MCAN-ED's forward with ``GraphVQAModel``'s call and return:
    ``forward(question (B, T) int, image, qlen (B,), *, train, generator)``
    -> (logits (B, out_dim - 1) f32, None, None); there is no adjacency.
    ``image`` is a ``RegionImage`` (the device table's gather), a
    (features (B, K, F), boxes) pair or a dense (B, K, F + 4) feat||bbox
    tensor (host mode); the boxes are not read, nor is ``qlen``: MCAN
    runs every position, its masks come from the ids and the regions.
    ``cfg.feat_dim`` counts the 4 box columns of the port's stores, so
    the regions are ``feat_dim - 4`` wide. Weights are made from ``seed``
    with torch's default initializers; ``load_state_dict`` replaces
    them."""

    # the logits hold no pad slot: evaluation masks none of them
    pad_logit = False
    # the device table its input is gathered from
    feature_cache = RegionCache
    # the tokens a question keeps: MCAN's MAX_TOKEN
    MAX_QLEN = 14

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        if cfg.quantized_inference or cfg.merged_block:
            raise ValueError("MCAN has no int8 serving path nor merged "
                             "graph block")
        self.cfg = cfg
        cdt = torch_dtype(cfg.compute_dtype)
        self.compute_dtype = cdt
        h = cfg.hid_dim
        self.embedding = nn.Embedding(cfg.vocab_size, cfg.emb_dim)
        self.lstm = LSTMWeights(cfg.emb_dim, h)
        self.img_feat_linear = Linear(cfg.feat_dim - 4, h, cdt)
        self.backbone = MCA_ED(cfg, cdt)
        self.attflat_img = AttFlat(cfg, cdt)
        self.attflat_lang = AttFlat(cfg, cdt)
        self.proj_norm = LayerNorm(2 * h)
        self.proj = Linear(2 * h, cfg.out_dim - 1, cdt)
        self.reset_parameters(seed)
        self.to(dev)

    @property
    def word_embedding(self) -> nn.Embedding:
        """The word-embedding module (state_dict name ``embedding``)."""
        return self.embedding

    def reset_parameters(self, seed: int) -> None:
        """The embedding N(0, 1); the LSTM U(-1/sqrt(H), 1/sqrt(H)); each
        Linear's weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), as
        torch's defaults draw them; LN a = 1, b = 0."""
        g = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            self.embedding.weight.normal_(generator=g)
            bound = 1.0 / math.sqrt(self.cfg.hid_dim)
            for p in self.lstm.parameters():
                p.uniform_(-bound, bound, generator=g)
            for mod in self.modules():
                if isinstance(mod, Linear):
                    bound = 1.0 / math.sqrt(mod.in_features)
                    mod.weight.uniform_(-bound, bound, generator=g)
                    mod.bias.uniform_(-bound, bound, generator=g)
                elif isinstance(mod, LayerNorm):
                    mod.a_2.fill_(1.0)
                    mod.b_2.fill_(0.0)

    def encode_question(self, emb: torch.Tensor) -> torch.Tensor:
        """(B, T, E) embeddings -> (B, T, H): one LSTM layer from zero
        state over every position."""
        cdt, w = self.compute_dtype, self.lstm
        b, t_len, _ = emb.shape
        hid = w.weight_hh_l0.shape[1]
        xp = (matmul(emb.to(cdt), w.weight_ih_l0.to(cdt).t())
              + (w.bias_ih_l0 + w.bias_hh_l0))
        w_hh = w.weight_hh_l0.to(cdt).t()
        h = emb.new_zeros((b, hid))
        c = emb.new_zeros((b, hid))
        out = []
        for t in range(t_len):
            gates = xp[:, t] + matmul(h.to(cdt), w_hh)
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        return torch.stack(out, dim=1)

    def regions(self, image):
        """(features (B, K, F), padding mask (B, K) bool) of ``image``."""
        if isinstance(image, RegionImage):
            feats, count = image
            pos = torch.arange(feats.shape[1], device=feats.device)
            return feats, pos[None, :] >= count[:, None]
        if isinstance(image, (tuple, list)):
            feats = image[0]
        else:
            feats = image[..., :self.cfg.feat_dim - 4]
        return feats, feats.float().abs().sum(-1) == 0

    def forward(self, question: torch.Tensor, image, qlen: torch.Tensor, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        """Eval (the default) runs under ``torch.no_grad``; ``train=True``
        records the graph for backward and draws dropout from
        ``generator`` (torch's default generator when None) in the
        order of the module's docstring."""
        del qlen
        with device_guard(question.device):
            if not train:
                with torch.no_grad():
                    return self._forward(question, image, 0.0, None)
            return self._forward(question, image, self.cfg.dropout,
                                 generator)

    def _forward(self, question, image, rate, generator):
        feats, region_pad = self.regions(image)
        token_pad = question == 0
        y = self.encode_question(F.embedding(question.long(),
                                             self.embedding.weight))
        x = self.img_feat_linear(feats)
        y, x = self.backbone(y, x, token_pad, region_pad, rate, generator)
        flat = (self.attflat_lang(y, token_pad, rate, generator)
                + self.attflat_img(x, region_pad, rate, generator))
        return self.proj(self.proj_norm(flat)), None, None

    @staticmethod
    def loss(logits: torch.Tensor, targets: torch.Tensor,
             sample_mask: Optional[torch.Tensor] = None,
             count: Optional[torch.Tensor] = None) -> torch.Tensor:
        """MCAN's loss: the BCE summed over the batch and the answers
        (``ops.losses.bce_sum_loss``); the labels' pad column, past the
        logits, is left out. A sum needs no global ``count``."""
        del count
        return bce_sum_loss(logits, targets[:, :logits.shape[1]],
                            sample_mask)
