"""The conditioned-graph VQA model as torch modules (eval and train
forward).

Counterpart of ``vqa_project_tpu/models/graph_vqa.py``. ``forward``
returns the same triple (logits, adjacency, h_max_indices). Parameters
carry the reference's torch state_dict names (``wembed.weight``,
``q_gru.*_l0``, ``adjacency_1.edge_layer_{1,2}.{weight_g,weight_v,bias}``,
``graph_convolution_{1,2}.conv_weights.{i}.weight`` and the (n, 1)
Gaussian parameters, ``out_{1,2}.*``), so a reference checkpoint loads
with ``load_state_dict`` as it is.

Numerics follow the JAX policy: parameters in float32; matmuls with
operands in the compute dtype and float32 accumulation; pseudo-
coordinates, Gaussian weights, softmax and logits in float32. The GRU
recurrence and both graph-convolution tails run in the CUDA kernels of
``ops/gru_scan.py`` and ``ops/edge_aggregate.py`` on CUDA tensors, and
in training their backward kernels too. With ``ModelConfig.merged_block``
the neighbourhood selection, both convolutions and their projections
run instead as one merged block (``ops/graph_block.py``, kernels H and
I), on the same parameters.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vqa_project_tpu_torch.config import (ModelConfig, resolve_device,
                                          torch_dtype)
from vqa_project_tpu_torch.ops import (bbox_centres, fused_graph_block,
                                       fused_sel_aggregate_act,
                                       gru_encode_kernel,
                                       masked_neighbourhood,
                                       polar_pseudo_coords)
from vqa_project_tpu_torch.ops.dropout import dropout
from vqa_project_tpu_torch.ops.gather_rows import NodeImage
from vqa_project_tpu_torch.ops.graph_block import padded_rows
from vqa_project_tpu_torch.ops.matmul import matmul


def _uniform(t: torch.Tensor, lo: float, hi: float,
             g: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(lo, hi, generator=g)


class WeightNormLinear(nn.Module):
    """Linear layer with weight normalization over the input axis.

    y = (x @ v^T) * (g / max(||v||, 1e-12)) + b, per output column: the
    explicit form of ``nn.utils.weight_norm(nn.Linear(...))`` with the
    scale applied to the output rather than to a materialized weight.
    With ``shared`` (B, D2) the layer behaves as if
    concat([x, broadcast(shared)], -1) were passed for x (B, K, D1),
    but the shared half of the product runs once per image.
    """

    def __init__(self, in_features: int, out_features: int, *,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 out_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.out_dtype = out_dtype or compute_dtype
        self.weight_g = nn.Parameter(torch.empty(out_features, 1))
        self.weight_v = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, g: torch.Generator) -> None:
        """torch Linear init for v and b; g = ||v|| so that w == v."""
        bound = 1.0 / math.sqrt(self.weight_v.shape[1])
        _uniform(self.weight_v, -bound, bound, g)
        _uniform(self.bias, -bound, bound, g)
        with torch.no_grad():
            self.weight_g.copy_(self.weight_v.norm(dim=1, keepdim=True))

    def forward(self, x: torch.Tensor,
                shared: Optional[torch.Tensor] = None) -> torch.Tensor:
        cdt = self.compute_dtype
        v = self.weight_v
        norm = torch.linalg.vector_norm(v.float(), dim=1)
        scale = self.weight_g.float().reshape(-1) / torch.clamp(norm,
                                                                 min=1e-12)
        d1 = x.shape[-1]
        y = matmul(x.to(cdt), v[:, :d1].to(cdt).t())
        if shared is not None:
            if x.dim() != 3 or shared.dim() != 2:
                raise ValueError("shared= expects x (B, K, d1) and shared "
                                 "(B, d2)")
            y = y + matmul(shared.to(cdt), v[:, d1:].to(cdt).t())[:, None]
        y = (y * scale).to(self.out_dtype)
        return y + self.bias.to(self.out_dtype)


class GraphLearner(nn.Module):
    """Question-conditioned dense adjacency A = E E^T, with E from two
    weight-normed Linear+ReLU layers."""

    def __init__(self, in_dim: int, combined_dim: int, *,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.edge_layer_1 = WeightNormLinear(
            in_dim, combined_dim, compute_dtype=compute_dtype)
        self.edge_layer_2 = WeightNormLinear(
            combined_dim, combined_dim, compute_dtype=compute_dtype)

    def forward(self, graph_nodes: torch.Tensor,
                shared: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = torch.relu(self.edge_layer_1(graph_nodes, shared=shared))
        h = torch.relu(self.edge_layer_2(h))
        # operands rounded to the compute dtype, products summed in f32
        e = h.to(self.compute_dtype).float()
        return torch.bmm(e, e.transpose(1, 2))


class GaussianGraphConv(nn.Module):
    """MoNet Gaussian-kernel graph convolution over selected edges.

    The n per-kernel projections (the reference's bias-free Linears,
    ``conv_weights.{i}``) run as one (in, n*d) matmul; the Gaussian
    weighting, aggregation and the relu that follows both convolutions
    run in ``fused_sel_aggregate_act``.
    """

    def __init__(self, in_dim: int, out_dim: int, n_kernels: int, *,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if out_dim % n_kernels:
            raise ValueError(f"out_dim {out_dim} not divisible by "
                             f"n_kernels {n_kernels}")
        self.compute_dtype = compute_dtype
        self.conv_weights = nn.ModuleList(
            nn.Linear(in_dim, out_dim // n_kernels, bias=False)
            for _ in range(n_kernels))
        self.mean_rho = nn.Parameter(torch.empty(n_kernels, 1))
        self.mean_theta = nn.Parameter(torch.empty(n_kernels, 1))
        self.precision_rho = nn.Parameter(torch.empty(n_kernels, 1))
        self.precision_theta = nn.Parameter(torch.empty(n_kernels, 1))

    def reset_parameters(self, g: torch.Generator) -> None:
        for lin in self.conv_weights:
            bound = 1.0 / math.sqrt(lin.weight.shape[1])
            _uniform(lin.weight, -bound, bound, g)
        _uniform(self.mean_rho, 0.0, 1.0, g)
        _uniform(self.mean_theta, -math.pi, math.pi, g)
        _uniform(self.precision_rho, 0.0, 1.0, g)
        _uniform(self.precision_theta, 0.0, 1.0, g)

    def gparams(self) -> torch.Tensor:
        """(4, n) [mu_rho; mu_theta; prec_rho; prec_theta], float32."""
        return torch.cat([self.mean_rho, self.mean_theta,
                          self.precision_rho, self.precision_theta],
                         dim=1).t().float().contiguous()

    def forward(self, features: torch.Tensor, selection: torch.Tensor,
                pseudo: torch.Tensor, dropout_rate: float = 0.0,
                seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        cdt = self.compute_dtype
        w = torch.cat([lin.weight.to(cdt) for lin in self.conv_weights])
        proj = matmul(features.to(cdt), w.t(), out_dtype=cdt)  # (B, K, nd)
        return fused_sel_aggregate_act(
            selection.float().contiguous(), pseudo.float().contiguous(),
            proj.contiguous(), self.gparams(), relu=True,
            dropout_rate=dropout_rate, seeds=seeds)


class GRUWeights(nn.Module):
    """Holder of the GRU parameters under ``nn.GRU``'s names; the
    recurrence itself runs in ``ops.gru_scan``."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.weight_ih_l0 = nn.Parameter(torch.empty(3 * hidden_size,
                                                     input_size))
        self.weight_hh_l0 = nn.Parameter(torch.empty(3 * hidden_size,
                                                     hidden_size))
        self.bias_ih_l0 = nn.Parameter(torch.empty(3 * hidden_size))
        self.bias_hh_l0 = nn.Parameter(torch.empty(3 * hidden_size))

    def reset_parameters(self, g: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight_hh_l0.shape[1])
        for p in self.parameters():
            _uniform(p, -bound, bound, g)


class GraphVQAModel(nn.Module):
    """Full conditioned-graph VQA forward pass.

    ``forward(question (B, T) int, image (B, K, feat_dim) float32 with
    the xyxy box in the last 4 channels, a (features (B, K,
    feat_dim - 4), boxes (B, K, 4) float32) pair, or the device cache's
    ``NodeImage`` (nodes already in the compute dtype), qlen (B,) int)``
    returns
    (logits (B, out_dim) f32, adjacency (B, K, K) f32, h_max_indices
    (B, hid_dim) int64). Weights are made from ``seed`` with torch's
    default initializers; ``load_state_dict`` replaces them.
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        cdt = torch_dtype(cfg.compute_dtype)
        self.compute_dtype = cdt
        h = cfg.hid_dim
        self.wembed = nn.Embedding(cfg.vocab_size, cfg.emb_dim)
        self.q_gru = GRUWeights(cfg.emb_dim, h)
        self.adjacency_1 = GraphLearner(cfg.feat_dim + h, cfg.combined_dim,
                                        compute_dtype=cdt)
        self.graph_convolution_1 = GaussianGraphConv(
            cfg.feat_dim, 2 * h, cfg.n_kernels, compute_dtype=cdt)
        self.graph_convolution_2 = GaussianGraphConv(
            2 * h, h, cfg.n_kernels, compute_dtype=cdt)
        self.out_1 = WeightNormLinear(h, cfg.out_dim, compute_dtype=cdt)
        self.out_2 = WeightNormLinear(cfg.out_dim, cfg.out_dim,
                                      compute_dtype=cdt,
                                      out_dtype=torch.float32)
        self.reset_parameters(seed)
        self.to(dev)

    def reset_parameters(self, seed: int) -> None:
        g = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            self.wembed.weight.normal_(generator=g)
        for mod in (self.q_gru, self.adjacency_1.edge_layer_1,
                    self.adjacency_1.edge_layer_2, self.graph_convolution_1,
                    self.graph_convolution_2, self.out_1, self.out_2):
            mod.reset_parameters(g)

    def forward(self, question: torch.Tensor, image: torch.Tensor,
                qlen: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Eval (the default) runs under ``torch.no_grad``; ``train=True``
        records the graph for backward and applies dropout, drawn from
        ``generator`` (a generator on the model's device), in the JAX
        model's places: on the feat||bbox vector, fused into conv1's
        epilogue with per-image int32 seeds, and after the classifier's
        first layer (torch's default generator when none is given)."""
        if not train:
            with torch.no_grad():
                return self._forward(question, image, qlen, 0.0, None)
        return self._forward(question, image, qlen, self.cfg.dropout,
                             generator)

    def _forward(self, question, image, qlen, rate, generator):
        cfg, cdt = self.cfg, self.compute_dtype
        nodes = None
        if isinstance(image, NodeImage):
            # the device cache's gather wrote the nodes themselves, in
            # the compute dtype and (for the merged block) padded rows,
            # and the f32 boxes
            nodes, boxes = image
            if nodes.dtype != cdt:
                raise TypeError(f"NodeImage nodes in {nodes.dtype}, the "
                                f"model computes in {cdt}")
        elif isinstance(image, (tuple, list)):
            # a (features, boxes) pair: features in the table's dtype,
            # boxes in f32; the node tensor is the same as from the
            # concatenated image
            feats, boxes = image
            parts = [feats, boxes]
        else:
            boxes, parts = image, [image]
        pseudo = polar_pseudo_coords(bbox_centres(boxes.float()))
        if cfg.merged_block:
            # the block reads the nodes' rows by TMA (16-byte row
            # strides): build them in rows padded to a multiple of 8
            # elements and keep the unpadded view; dropout writes there too
            if nodes is None:
                nodes = padded_rows(parts, cdt)
            nodes = dropout(nodes, rate, generator, out=nodes)
        else:
            if nodes is None:
                nodes = (torch.cat([p.to(cdt) for p in parts], dim=-1)
                         if len(parts) > 1 else parts[0].to(cdt))
            nodes = dropout(nodes, rate, generator)

        emb = F.embedding(question.long(), self.wembed.weight)
        g = self.q_gru
        qenc = gru_encode_kernel(emb, qlen, g.weight_ih_l0, g.weight_hh_l0,
                                 g.bias_ih_l0, g.bias_hh_l0,
                                 compute_dtype=cdt)

        adjacency = self.adjacency_1(nodes, shared=qenc.to(cdt))
        # the seeds come at the same point of the generator's stream on
        # both paths (the selection draws nothing), so the later dropout
        # draws line up too
        seeds = None
        if rate > 0:
            seeds = torch.randint(0, 2 ** 31 - 1, (question.shape[0],),
                                  generator=generator, device=nodes.device,
                                  dtype=torch.int32)
        if cfg.merged_block:
            hg2 = self._graph_block(nodes, adjacency, pseudo, rate, seeds)
        else:
            alpha, mask = masked_neighbourhood(adjacency,
                                               cfg.neighbourhood_size)
            hg1 = self.graph_convolution_1(nodes, alpha, pseudo,
                                           dropout_rate=rate, seeds=seeds)
            hg2 = self.graph_convolution_2(hg1, mask, pseudo)

        h_max_indices = torch.argmax(hg2, dim=1)             # (B, hid)
        # amax splits the gradient evenly among tied maxima, as jnp.max
        pooled = torch.amax(hg2, dim=1)
        fused = torch.relu(qenc) * pooled                     # f32
        h1 = dropout(torch.relu(self.out_1(fused)), rate, generator)
        logits = self.out_2(h1)                               # f32
        return logits, adjacency, h_max_indices

    def _graph_block(self, nodes, adjacency, pseudo, rate, seeds):
        """Both convolutions as one merged block (kernels H and I): each
        conv's Linears stacked into the block's (n, in, d) layout, the
        neighbourhood selected inside the block from the adjacency."""
        c1, c2 = self.graph_convolution_1, self.graph_convolution_2
        w1 = torch.stack([lin.weight.t() for lin in c1.conv_weights])
        w2 = torch.stack([lin.weight.t() for lin in c2.conv_weights])
        return fused_graph_block(
            adjacency.float(), pseudo.float(), nodes.to(self.compute_dtype),
            w1, c1.gparams(), w2, c2.gparams(), seeds,
            self.cfg.neighbourhood_size, rate)
