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
I), on the same parameters. With ``ModelConfig.quantized_inference``
(serving only) the projections of both convolutions and the weight-norm
layers are int8 products (``ops/quant.py``), loaded from
``quantize_state_dict_for_serving`` of a float state_dict; the
aggregations still run in kernel A.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vqa_project_tpu_torch.config import (ModelConfig, device_guard,
                                          resolve_device, torch_dtype)
from vqa_project_tpu_torch.ops import quant
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

    ``quantized=True`` (serving): ``weight_q`` int8 (out, in) and
    ``weight_scale`` f32 (out,), with g / ||v|| folded into the scale,
    replace ``weight_v`` and ``weight_g``. The product stays split: x's
    columns 0..split-1 and shared's columns split.. are two int8
    products, each with its own activation scale. The zero-padded
    operands of the two halves are made once per weight load.
    """

    def __init__(self, in_features: int, out_features: int, *,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 out_dtype: Optional[torch.dtype] = None,
                 quantized: bool = False, split: Optional[int] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.out_dtype = out_dtype or compute_dtype
        self.quantized = quantized
        if quantized:
            # the width of x when `shared` is passed: where codes split
            self.split = in_features if split is None else int(split)
            self.register_buffer("weight_q", torch.zeros(
                out_features, in_features, dtype=torch.int8))
            self.register_buffer("weight_scale", torch.ones(out_features))
            self.register_buffer("_operand_x", None, persistent=False)
            self.register_buffer("_operand_shared", None, persistent=False)
            self._pad_operands()
            self.register_load_state_dict_post_hook(_pad_after_load)
        else:
            self.weight_g = nn.Parameter(torch.empty(out_features, 1))
            self.weight_v = nn.Parameter(torch.empty(out_features,
                                                     in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def _pad_operands(self) -> None:
        q = self.weight_q
        self._operand_x = quant.pad_int8_weight(q[:, :self.split])
        self._operand_shared = (quant.pad_int8_weight(q[:, self.split:])
                                if self.split < q.shape[1] else None)

    def reset_parameters(self, g: torch.Generator) -> None:
        """torch Linear init for v and b; g = ||v|| so that w == v. A
        quantized layer keeps zero codes and unit scales until a
        quantized state_dict is loaded (its bias drawn as b's)."""
        w = self.weight_q if self.quantized else self.weight_v
        bound = 1.0 / math.sqrt(w.shape[1])
        if not self.quantized:
            _uniform(self.weight_v, -bound, bound, g)
        _uniform(self.bias, -bound, bound, g)
        if not self.quantized:
            with torch.no_grad():
                self.weight_g.copy_(self.weight_v.norm(dim=1, keepdim=True))

    def forward(self, x: torch.Tensor,
                shared: Optional[torch.Tensor] = None) -> torch.Tensor:
        if shared is not None and (x.dim() != 3 or shared.dim() != 2):
            raise ValueError("shared= expects x (B, K, d1) and shared "
                             "(B, d2)")
        if self.quantized:
            return self._forward_int8(x, shared)
        cdt = self.compute_dtype
        v = self.weight_v
        norm = torch.linalg.vector_norm(v.float(), dim=1)
        scale = self.weight_g.float().reshape(-1) / torch.clamp(norm,
                                                                 min=1e-12)
        d1 = x.shape[-1]
        y = matmul(x.to(cdt), v[:, :d1].to(cdt).t())
        if shared is not None:
            y = y + matmul(shared.to(cdt), v[:, d1:].to(cdt).t())[:, None]
        y = (y * scale).to(self.out_dtype)
        return y + self.bias.to(self.out_dtype)

    def _forward_int8(self, x, shared):
        d1 = x.shape[-1]
        if d1 != self.split or (shared is None) != (
                self._operand_shared is None):
            raise ValueError(f"the int8 layer splits its input at "
                             f"{self.split}, got x of width {d1} and "
                             f"shared {None if shared is None else 'given'}")
        y = quant.int8_matmul(x.reshape(-1, d1), self._operand_x.t(),
                              self.weight_scale).reshape(*x.shape[:-1], -1)
        if shared is not None:
            y = y + quant.int8_matmul(shared, self._operand_shared.t(),
                                      self.weight_scale)[:, None]
        y = y.to(self.out_dtype)
        return y + self.bias.to(self.out_dtype)


def _pad_after_load(module, incompatible_keys) -> None:
    """A quantized layer's padded operands follow its loaded codes."""
    module._pad_operands()


class GraphLearner(nn.Module):
    """Question-conditioned dense adjacency A = E E^T, with E from two
    weight-normed Linear+ReLU layers."""

    def __init__(self, in_dim: int, combined_dim: int, *,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 quantized: bool = False, split: Optional[int] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.edge_layer_1 = WeightNormLinear(
            in_dim, combined_dim, compute_dtype=compute_dtype,
            quantized=quantized, split=split)
        self.edge_layer_2 = WeightNormLinear(
            combined_dim, combined_dim, compute_dtype=compute_dtype,
            quantized=quantized)

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
    run in ``fused_sel_aggregate_act``. ``quantized=True`` (serving):
    the projection is one int8 product of ``conv_weights_q`` (n*d, in)
    int8 and ``conv_weights_scale`` f32, its result cast to the compute
    dtype for the aggregation.
    """

    def __init__(self, in_dim: int, out_dim: int, n_kernels: int, *,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 quantized: bool = False):
        super().__init__()
        if out_dim % n_kernels:
            raise ValueError(f"out_dim {out_dim} not divisible by "
                             f"n_kernels {n_kernels}")
        self.compute_dtype = compute_dtype
        self.quantized = quantized
        if quantized:
            self.register_buffer("conv_weights_q", torch.zeros(
                out_dim, in_dim, dtype=torch.int8))
            self.register_buffer("conv_weights_scale", torch.ones(out_dim))
            self.register_buffer("_operand", None, persistent=False)
            self._pad_operands()
            self.register_load_state_dict_post_hook(_pad_after_load)
        else:
            self.conv_weights = nn.ModuleList(
                nn.Linear(in_dim, out_dim // n_kernels, bias=False)
                for _ in range(n_kernels))
        self.mean_rho = nn.Parameter(torch.empty(n_kernels, 1))
        self.mean_theta = nn.Parameter(torch.empty(n_kernels, 1))
        self.precision_rho = nn.Parameter(torch.empty(n_kernels, 1))
        self.precision_theta = nn.Parameter(torch.empty(n_kernels, 1))

    def _pad_operands(self) -> None:
        self._operand = quant.pad_int8_weight(self.conv_weights_q)

    def reset_parameters(self, g: torch.Generator) -> None:
        """torch Linear init for the projections (a quantized conv keeps
        zero codes until a quantized state_dict is loaded) and the
        Gaussians' ranges."""
        for lin in ([] if self.quantized else self.conv_weights):
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
        if self.quantized:
            b, k = features.shape[:2]
            proj = quant.int8_matmul(
                features.reshape(b * k, -1), self._operand.t(),
                self.conv_weights_scale).to(cdt).reshape(b, k, -1)
        else:
            w = torch.cat([lin.weight.to(cdt) for lin in self.conv_weights])
            proj = matmul(features.to(cdt), w.t(), out_dtype=cdt)
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
    default initializers; ``load_state_dict`` replaces them. A model with
    ``quantized_inference`` loads ``quantize_state_dict_for_serving`` of
    a float state_dict, serves only (its train-mode forward raises) and
    refuses ``merged_block``, as the JAX package's does.
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        q8 = cfg.quantized_inference
        if q8 and cfg.merged_block:
            raise ValueError("quantized_inference does not run the merged "
                             "block (its kernels take float weights)")
        self.cfg = cfg
        cdt = torch_dtype(cfg.compute_dtype)
        self.compute_dtype = cdt
        h = cfg.hid_dim
        self.wembed = nn.Embedding(cfg.vocab_size, cfg.emb_dim)
        self.q_gru = GRUWeights(cfg.emb_dim, h)
        self.adjacency_1 = GraphLearner(cfg.feat_dim + h, cfg.combined_dim,
                                        compute_dtype=cdt, quantized=q8,
                                        split=cfg.feat_dim)
        self.graph_convolution_1 = GaussianGraphConv(
            cfg.feat_dim, 2 * h, cfg.n_kernels, compute_dtype=cdt,
            quantized=q8)
        self.graph_convolution_2 = GaussianGraphConv(
            2 * h, h, cfg.n_kernels, compute_dtype=cdt, quantized=q8)
        self.out_1 = WeightNormLinear(h, cfg.out_dim, compute_dtype=cdt,
                                      quantized=q8)
        self.out_2 = WeightNormLinear(cfg.out_dim, cfg.out_dim,
                                      compute_dtype=cdt,
                                      out_dtype=torch.float32, quantized=q8)
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
        first layer (torch's default generator when none is given). The
        kernels launch with the inputs' card current (``device_guard``);
        the backward's run on autograd's thread for that card."""
        with device_guard(question.device):
            if not train:
                with torch.no_grad():
                    return self._forward(question, image, qlen, 0.0, None)
            if self.cfg.quantized_inference:
                raise ValueError("quantized_inference serves only: there is "
                                 "no int8 backward")
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
