#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check every phase.

    python3 chip_smoke.py

Phases, in order; the first failure exits non-zero:

1. device: needs CUDA; prints the card's name and power limit; TF32 off;
2. build: compiles the CUDA kernels of vqa_project_tpu_torch/csrc;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the serving shapes (f32 and bf16); kernel A also at the medical
   K=51 and at K = 1, 17, 64, n = 1 and 8, B = 1 and 257, d = 40, and
   at the bf16 shapes the rule sends to the SIMT body (K=72, d=36), the
   aggregation rule's pick asserted, its bf16 body run again into
   NaN-filled outputs equal bit for bit, and for the mma body the share
   of outputs rounded otherwise than bf16(the f32 plain value) at most
   2%, where a one-pass control of the weights (bf16 hi alone) must
   exceed it (the main path's shapes); kernel B at B = 1, 16, 64, 200
   and 256 (past 128 rows the persistent kernel splits the batch) with
   qlen spread over 0..T and all equal, persistent (bf16) and per step
   (f32), two runs equal bit for bit; in bf16 also the persistent kernel
   at B=150 (96-wide K chunks) and H = 128, 256, and the per-step kernel
   at B=257;
4. full-width forward (VQA v2 widths, random weights from a seed): the
   port on the card against the same port on the CPU;
5. serving, the main path: InferenceServer behind its HTTP front-end
   answers 64 requests from 8 keep-alive clients; every answer is held
   against a direct forward, and both kernels must have launched;
7. training kernels against their plain versions on the card: C and D
   at the VQA conv1/conv2 shapes (B=64), the medical K=51, m=19 (B=8)
   and phase 3's edge shapes (D only at K <= 64), f32 (SIMT bodies)
   and bf16 (the rule's bodies, run again into NaN-filled outputs equal
   bit for bit; for the mma bodies the rounding share of out and dproj
   and its one-pass control, as in phase 3), with conv1's
   dropout epilogue (masks bit for bit in both dtypes, kept fraction,
   repeatability, per-image seeds); B's states and hp and
   E at T=16, H=1024: in bf16 at B = 1, 8, 50, 64, 150, 200 and 256, qlen
   spread over 0..T and all equal, hs16 equal to hs in bf16 bit for bit,
   hp within f32 rounding of the product recomputed from B's own states,
   E's persistent sweep (one launch) within 5e-3 normalized of its plain
   version fed the same hp, a second run and a run into NaN-filled
   outputs equal bit for bit, and the weight gradient (the wgmma product
   from hs16) within 1e-4, equal bit for bit to a run into NaN-filled
   outputs; in f32 at B = 8, 50, 64, 256 the per-step sweep within 1e-5
   and the SIMT weight gradient; the same bf16 checks at H = 64, 128,
   192, 256 (B = 8, 50); the bf16 per-step sweep where the rule sends
   bf16 to it (B=257 at H=1024, H=1032) within 1e-2 of its plain version,
   a second run equal bit for bit, with the weight gradient its shape
   takes (wgmma at H=1024, SIMT at H=1032);
8. one full-width f32 training step (dropout 0) on the card against the
   same step on the CPU: loss, every gradient, the Adam update;
9. training, the main path: fit() on an in-memory synthetic dataset at
   full VQA width, batch 64, bf16, dropout 0.5, 20 steps and one
   mini-validation; the launch counts per step must be C 2, D 2, B 1
   (the persistent kernel), E 1 + 1 (the persistent sweep, then the
   weight gradient), and A 0;
10. gather kernels against their plain versions, bit for bit: F on a
    device-made VQA v2-size table (123,287 x 36 x 2048) in bf16, then
    int8 with per-box scales into bf16 and f32, and f32 at N=4096, at
    B in {1, 16, 33, 63, 64, 65, 256, 257}; rows of 21 and 15 16-byte
    vectors (bf16; int8 dequantized and copied as it is) and the int8
    element-wise variant (F=20) at B in {1, 63, 65, 257}; and at B = 1,
    65, 257 a run into outputs filled with NaN (-128 for an int8 copy)
    first; G
    on the (N, 36, 4) boxes and odd row shapes at B in {1, 16, 33, 64,
    256}; rows 0 and N-1, duplicates and clamped -1 / N; the image
    gather (G's redesign, one launch writing the node rows feat||bbox
    and the f32 boxes) against its plain version bit for bit, on the
    VQA v2-size bf16 and int8 tables and at N=4096 in f32, at K = 36
    and 51, for every (table, node) dtype pair (bf16 and f32 nodes from
    bf16, f32 and int8 tables), contiguous and padded rows, at every B
    above, into NaN-filled buffers whose pad columns must come back 0,
    and on shapes that take its element-wise variant;
11. training with the device cache, the main path: fit() as in phase 9
    but with the bf16 feature cache, index batches and a resident
    mini-validation; per step the image gather 1, F 0, G 0, C 2, D 2,
    B 1, E 1 + 1, A 0, and step 1's loss equal to phase 9's bit for bit;
12. evaluate() to result.json with phase 11's model: val through the
    cache (resident, one image gather per batch) and through host mode
    (streaming) give the same result list; the unannotated test split;
    collect_adjacency; an int8 cache;
13. the merged block's kernels against their plain versions: the bare
    GEMM against torch.mm at the block's six products (NN, NT, TN; f32
    and bf16) and its epilogues; the wgmma product against torch.mm at
    the same six products (H's NN proj1 from rows padded to 2056 and
    proj2; I's TN dW2 and dW1, A rows padded to 2056, and NT dh1 and
    dfeats, through I's gate and the bf16 store against the plain
    epilogues) for B*K = 36 to 9252, every tile and the rule's pick, a
    rerun bit for bit; H and I at the VQA widths (B = 64, 1 and 257),
    the medical K=51, m=19 (B=8), n=1, d1=40 and a width whose n*d2-wide
    products go to tile_gemm, f32 and bf16, dropout 0.5: H with feats
    as padded rows and contiguous equal bit for bit, reruns of H and I
    into NaN-filled outputs equal bit for bit, the products H and I
    launched (wgmma or tile_gemm, read from a profile) asserted, at n=1
    (every Gaussian above the 1e-20 clamp) I's dpseudo and dgparams
    exactly 0, as the plain version's, and
    in f32 H's conv1 output equal to kernel C's bit for bit;
14. training with the merged block, the main path: fit() as in phase 11
    with ModelConfig(merged_block=True); per step H 1, I 1, A, C, D 0,
    B 1, E 1 + 1, the image gather 1 (into padded rows), F 0, G 0, and
    step 1's loss within 1e-2 of phase 11's; the merged serving forward at B=16 launches H and B once and
    not A and picks the unmerged answer on >= 75% of rows;
15. the CLI from files, the main path (in a temporary working
    directory): the port's blosc decoder builds and decodes the committed
    frames of tests/fixtures/blosc/ bit for bit; cli.run.main in this
    process with --synthetic at full VQA v2 width (512 images of 36 x
    2048 written as zlib zarr, packed once and cached on the card in
    bf16; 3000 answers, 12k words, 2560 questions, batch 64): --train
    for 2 epochs with phase 11's launches per step (the mini-validations'
    taken out), per-epoch checkpoints and finite losses; --train resumed
    from the epoch-1 checkpoint, its epoch-2 windows equal bit for bit;
    --eval from the epoch-2 checkpoint, its accuracy equal to evaluate()'s,
    result.json one row per question, per batch the image gather 1, A 2,
    B 1; --test without an accuracy; --trainval for one epoch, its named
    .pt loaded by load_reference_checkpoint into a fresh model that
    answers the val split as the trained one; the pack time, fit's
    median step beside phase 11's and --eval's questions/s printed;
16. the serving CLI from files, the main path (phase 15's directory,
    set and trained epoch-2 checkpoint): the checkpoint written again
    as a JAX-layout msgpack with its Adam state (write_jax_checkpoint,
    no flax) and read back bit for bit, its load time printed;
    cli.serve.build_server of it serving 64 requests from 8 keep-alive
    clients over HTTP at B = 16 and 256, in bf16 (every answer equal to
    a direct forward's top-1) and with --quantize (top-1 agreeing with
    bf16 on >= 90%), A 2 and B 1 launched per served batch, p50 and p99
    printed; the exported reference .pt and the port's checkpoint
    serving the msgpack's bf16 answers and int8 weights bit for bit;
    python -m ...cli.serve --quantize in a process of its own, then
    stopped; at B = 16 and 256 the seven int8 products' int32 sums on
    the card equal to the CPU plain version's bit for bit, 7
    aten::_int_mm per forward in a profile, and the products, the
    activation quantization and the forwards timed beside bf16;
    cli.export_torch's .pt reloaded bit for bit and cli.validate_parity
    printing evaluate()'s accuracy;
17. the medical grid search from files, the main path (in a temporary
    working directory): A, C and D at the grid's corners (B=8, K=51,
    n = 4 and 32 by m = 16 and 36, conv1's and conv2's widths) against
    their plain versions as phases 3 and 7 hold them (conv1's dropout
    at the medical 0.4), then timed beside their bounds;
    cli.run_imageclef.main over those four cells at full width (256
    images of 51 x 2048 written by --synthetic, 2048 questions, 3000
    answers, hid 1024, bf16, batch 8, one epoch): four grid lines, four
    checkpoints that load back and answer val as their cells did, the
    best cell's CSV of every question, one cache build, per train step
    the image gather 1, C 2, D 2, B 1, E 1 + 1, A 0 and per eval batch
    the image gather 1, A 2, B 1, finite losses, the allocated bytes at
    each cell's start within one model of the first's, and a profile of
    a step at n = 4 and 32; cli.run_mimic.main's preset cell under
    --fast_math with its own val store (two cache builds, every Adam
    moment bfloat16), an async_save_checkpoint equal to a synchronous
    save, and a profiling.trace of two annotated steps; per cell the
    StepTimer's p50 and QA pairs/s and evaluate's questions/s printed;
18. the interpretability plots from files, the main path (phase 15's
    directory, set and trained epoch-2 checkpoint; after phase 17):
    viz.collect_graphs (cli.plot's sweep: 4 batches of 32, bf16) from
    each of phase 16's checkpoint kinds (the port's .ckpt, the exported
    reference .pt, the JAX msgpack; written again where gone), per batch
    the image gather 1, A 2, B 1, the CSV rows evaluate()'s answers, the
    npz 128 (36, 36) f32 adjacencies equal bit for bit across the kinds;
    the same sweep in f32 on the card and on the CPU (adjacency within
    1e-4 x max|A|, top-1 agreeing on >= 99%, top-7 node sets equal on
    >= 95%); viz.given_question_graph at B = 1 from the host store for 8
    questions (A 2, B 1, no gather each; bf16 answers equal the sweep's
    on >= 7, f32 adjacencies against the CPU as the sweep's); where
    matplotlib is installed cli.plot.main renders 128 figures, else a
    line says they were not rendered; phase 15's stores written as a
    base64 TSV and read back by features_to_zarr equal; the sweep's
    questions/s, collect_graphs' seconds, the B = 1 forward's wall p50
    and device ms and the phase's time printed;
19. data parallelism, the main path over several ranks (after phase 18;
    ``python3 chip_smoke.py --phase 19`` runs phases 1, 2 and 19 alone,
    ``--phase 19c`` only its legs that need several cards, (c) and (d)):
    phase 11's fit (dropout 0, every step logged) in one process, then
    (a) two ranks on card 0 over gloo, fresh interpreters under a hard
    timeout, global batch 64: the replicated cache with the f32 reduce
    (per-step losses within 2e-3 of the one-process fit's, per-step
    accuracies equal), the sharded cache forced by a budget of 3/4 of
    the table (against one process stepping the same locality batches),
    the bf16 reduce (within 2e-3 of the f32 reduce's losses, and
    learning), on each rank per step the image gather 1, C 2, D 2, B 1,
    E 1 + 1 and the ranks' weights equal; evaluate over the two ranks
    writing rank 0's result.json equal to one process's on the same
    weights (rank 1 none), its answers on >= 98% of val those of the
    one-process model, and the gloo all-reduce of the full gradient
    timed in f32 and bf16; (b) NCCL at world 1: the data-parallel fit's
    losses and weights equal to the single-card fit's bit for bit; (c)
    NCCL over every visible card up to 4 (else a line saying it did not
    run): the replicated and bf16 fits as in (a) against one card, the
    step's median ms and device busy share, the NCCL all-reduce of the
    gradient in f32 and bf16, and from 3 cards the VQA v2-size bf16 table
    (123,287 images) sharded under the default 8 GiB budget with each
    rank's bytes and a locality step's ms, and with an even count of
    cards tensor parallelism, dp n/2 x tp 2 (per-step losses within 2e-3
    of one card's, accuracies equal, weights equal within each model
    group, the launches per rank per step as in (a), the NCCL all-gather
    of the Adam shards timed); (d) InferenceServer over [cuda:0, cuda:0]
    (and every card where there are more), the unmerged and the merged
    model: top-1 equal to one device's on 64 requests; (e) dp 1 x tp 2,
    two ranks on card 0 over gloo (``TrainConfig(tp=2)``, the same fit):
    losses and weights equal to the one-process fit's bit for bit, the
    launches per rank per step as in (a), the parameters that shard, each
    rank's Adam moment bytes against the whole, the gloo all-gather's ms;
20. the fused Adam kernel (``python3 chip_smoke.py --phase 20`` runs
    phases 1, 2 and 20 alone; in the full run it comes after phase 19):
    adam_fused_step at VQA v2's and MCAN-large's parameter lists (every
    tensor of the models at their published widths, two empty ones
    added) and at unaligned shards, moments in f32 and in bf16, three
    steps against the plain _foreach version bit for bit, then (but the
    shards) timed (device time behind a
    sleep kernel) beside its byte bound, the plain version and, with f32
    moments, torch.optim.Adam(fused=True) as a yardstick only; and eight
    full-width bf16 train steps (B = 64, host batches) with one launch a
    step, the first eager and the rest inside the step's CUDA graph
    (adam.graphed 0, then 1);
6. timing, in four parts: after phase 5 the serving kernels and the
   forward at B=16 and 256 (kernel B at 16, 64 and 256 beside cuDNN and
   the per-step kernel; A beside a torch.bmm of the product alone),
   after phase 9 the training kernels
   (C and D beside torch.bmm of their products; C's bound from its
   bytes, product, Gaussians and Philox multiplies) and the
   training step at B=64 and 256 (E's sweep beside its plain version,
   the per-step sweep, cuDNN's GRU forward + backward and its forward
   alone; E's dW/db beside cuBLAS and the SIMT reduction; kernel B with
   and without hp), after phase 14 the gather kernels at
   B=64 and 256 (F and index_select six times each in turns; the int8
   path), the image gather in both layouts beside the F + G + cast +
   concatenation it replaces, F alone, the library sequence and its
   byte bound (six times each in turns), the
   cache-mode training step beside host mode (profiled: device busy
   and launches per step),
   evaluate's throughput, then H (feats as padded rows and contiguous,
   its five launches one by one), I (its launches one by one), the
   block's six products (every wgmma tile and the rule's pick beside
   tile_gemm and torch.mm) at
   B=64 and 256, the merged block beside the unmerged one and the
   merged training step beside the unmerged one; each kernel's device
   time (launches
   queued behind a sleep kernel) beside its plain version, the library
   call where one exists and the least time the card needs, and
   profiles of the forward and of the steps.

The last two lines are the kernels JSON and {"ok": true, "device": ...}.
Without a CUDA device, or without the repository beside it, the script
fails before printing any result.
"""

from __future__ import annotations

import base64
import contextlib
import csv
import dataclasses
import http.client
import importlib.util
import io
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from vqa_project_tpu_torch.cli import export_torch as export_cli
from vqa_project_tpu_torch import viz
from vqa_project_tpu_torch.cli import medical as medical_cli
from vqa_project_tpu_torch.cli import plot as plot_cli
from vqa_project_tpu_torch.cli import run as cli
from vqa_project_tpu_torch.cli import run_imageclef, run_mimic
from vqa_project_tpu_torch.cli import serve as serve_cli
from vqa_project_tpu_torch.cli import validate_parity as parity_cli
from vqa_project_tpu_torch.config import ModelConfig, TrainConfig
from vqa_project_tpu_torch.data import (Batcher, FeatureStore,
                                        GraphVQADataset,
                                        generate_synthetic_vqa, native,
                                        pack_index_batch, tokenize)
from vqa_project_tpu_torch.data import zarr_store
from vqa_project_tpu_torch.data.preprocess import image_features
from vqa_project_tpu_torch.data.store import _read_sizes_csv, pack_paths
from vqa_project_tpu_torch.models import (GraphVQAModel, make_model,
                                          load_reference_checkpoint)
from vqa_project_tpu_torch.models.graph_vqa import GaussianGraphConv
from vqa_project_tpu_torch.ops import quant
from vqa_project_tpu_torch.ops.adam import (AdamTable, adam_fused_step,
                                            adam_reference)
from vqa_project_tpu_torch.ops import (_build, bbox_centres,
                                       masked_neighbourhood,
                                       polar_pseudo_coords)
from vqa_project_tpu_torch.ops.dropout import keep_threshold, philox_keep
from vqa_project_tpu_torch.ops.matmul import matmul
from vqa_project_tpu_torch.ops.gather_rows import (gather_image_reference,
                                                   gather_image_rows,
                                                   gather_rows_blocked,
                                                   gather_rows_packed,
                                                   gather_rows_reference,
                                                   node_row_stride)
from vqa_project_tpu_torch.ops.edge_aggregate import (
    aggregate_kernel, fused_sel_aggregate_act, sel_aggregate_act_reference,
    sel_aggregate_act_residuals, sel_aggregate_act_residuals_reference,
    sel_aggregate_act_vjp, sel_aggregate_act_vjp_reference)
from vqa_project_tpu_torch.ops.graph_block import (
    BlockGrads, BlockResiduals, fused_graph_block, graph_block_bwd,
    graph_block_bwd_reference, graph_block_fwd, graph_block_fwd_reference,
    padded_rows, tile_gemm, tile_gemm_reference, wgmma_gemm)
from vqa_project_tpu_torch.ops.gru import (gru_scan_reference,
                                           gru_scan_sweep_reference,
                                           gru_wgrad_reference,
                                           input_projection)
from vqa_project_tpu_torch.ops.gru_scan import (gru_scan, gru_scan_bwd,
                                                gru_wgrad, scan_kernel,
                                                sweep_kernel, wgrad_kernel)
from vqa_project_tpu_torch.parallel import (make_mesh, make_mesh_2d,
                                            multihost, shard_batch)
from vqa_project_tpu_torch.serve import InferenceServer, make_http_server
from vqa_project_tpu_torch.train import loop as train_loop
from vqa_project_tpu_torch.train import profiling
from vqa_project_tpu_torch.train import (QuantizedFeatureCache, build_model,
                                         evaluate, fit, load_checkpoint,
                                         make_feature_cache, make_image_fn,
                                         make_optimizer, save_checkpoint,
                                         train_step)
from vqa_project_tpu_torch.train.state import (async_save_checkpoint,
                                               wait_for_async_saves)

SEED = 20261016
# VQA v2 widths (hid 1024, 8 kernels, 16 neighbours, K=36, 3001 answers,
# 300-d embeddings, 2048+4 region features, ~13k question words)
FULL = dict(vocab_size=13000, emb_dim=300, feat_dim=2052, hid_dim=1024,
            out_dim=3001, combined_dim=512, n_kernels=8,
            neighbourhood_size=16, n_obj=36, dropout=0.5, max_qlen=16)
# MCAN-large (arXiv:1906.10770) at its published widths, as ModelConfig
# takes them
MCAN_LARGE = dict(arch="mcan", vocab_size=20000, emb_dim=300, feat_dim=2052,
                  hid_dim=1024, out_dim=3130, n_obj=100, max_qlen=14,
                  dropout=0.1)
SERVE_B = 16
TRAIN_B = 64     # TrainConfig's default batch
DROPOUT = 0.5    # ModelConfig's default rate
ADAM_EPS = 1e-8
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
GAUSS_FLOPS = 25   # per (edge, kernel): two exp, two divides, ~20 more
# VQA v2's feature table: train2014 + val2014 images, 36 boxes of 2048
VQA_IMAGES = 123_287
GATE_FLOPS = 20    # per (row, unit, step): two sigmoid, tanh, blend

SOURCES = {
    "edge_aggregate_fwd": ("vqa_project_tpu_torch/csrc/edge_aggregate.cu",
                           "vqa_project_tpu/ops/pallas/edge_aggregate.py:194"),
    "gru_scan_fwd": ("vqa_project_tpu_torch/csrc/gru_scan.cu",
                     "vqa_project_tpu/ops/pallas/gru_scan.py:54"),
    "edge_aggregate_fwd_res": (
        "vqa_project_tpu_torch/csrc/edge_aggregate.cu",
        "vqa_project_tpu/ops/pallas/edge_aggregate.py:243"),
    "edge_aggregate_bwd": (
        "vqa_project_tpu_torch/csrc/edge_aggregate_bwd.cu",
        "vqa_project_tpu/ops/pallas/edge_aggregate.py:282"),
    "gru_scan_bwd_persistent": (
        "vqa_project_tpu_torch/csrc/gru_scan_bwd.cu",
        "vqa_project_tpu/ops/pallas/gru_scan.py:145"),
    "gru_wgrad": ("vqa_project_tpu_torch/csrc/gru_wgrad.cu",
                  "vqa_project_tpu/ops/pallas/gru_scan.py:145"),
    "gather_rows_packed": ("vqa_project_tpu_torch/csrc/gather_rows.cu",
                           "vqa_project_tpu/ops/pallas/gather_rows.py:91"),
    "gather_rows_blocked": ("vqa_project_tpu_torch/csrc/gather_rows.cu",
                            "vqa_project_tpu/ops/pallas/gather_rows.py:46"),
    "gather_image_rows": ("vqa_project_tpu_torch/csrc/gather_rows.cu",
                          "vqa_project_tpu/ops/pallas/gather_rows.py:46"),
    "graph_block_fwd": ("vqa_project_tpu_torch/csrc/graph_block.cu",
                        "vqa_project_tpu/ops/pallas/graph_block.py:77"),
    "graph_block_bwd": ("vqa_project_tpu_torch/csrc/graph_block_bwd.cu",
                        "vqa_project_tpu/ops/pallas/graph_block.py:217"),
}
# each kernel's wrapper, which counts its launches
WRAPPERS = {
    "edge_aggregate_fwd": fused_sel_aggregate_act,            # A
    "gru_scan_fwd": gru_scan,                                  # B
    "edge_aggregate_fwd_res": sel_aggregate_act_residuals,     # C
    "edge_aggregate_bwd": sel_aggregate_act_vjp,               # D
    "gru_scan_bwd_persistent": gru_scan_bwd,                   # E, sweep
    "gru_wgrad": gru_wgrad,                                    # E, dW/db
    "gather_rows_packed": gather_rows_packed,                  # F
    "gather_rows_blocked": gather_rows_blocked,                # G
    "gather_image_rows": gather_image_rows,                    # G, fused
    "graph_block_fwd": graph_block_fwd,                        # H
    "graph_block_bwd": graph_block_bwd,                        # I
}
# each counts through the one registry (ops/_build.py), whose counters a
# replayed train step adds its capture's launches to (train/steps.py)
if not all(any(fn is f for f in _build.COUNTED) for fn in WRAPPERS.values()):
    raise ImportError("a kernel wrapper counts outside _build.COUNTED")
# launches of one bf16 training step (host mode: no gather); kernels B
# and E's sweep are persistent, one launch each for all 16 steps
TRAIN_STEP_LAUNCHES = {
    "edge_aggregate_fwd": 0, "gru_scan_fwd": 1, "edge_aggregate_fwd_res": 2,
    "edge_aggregate_bwd": 2, "gru_scan_bwd_persistent": 1, "gru_wgrad": 1,
    "gather_rows_packed": 0, "gather_rows_blocked": 0,
    "gather_image_rows": 0, "graph_block_fwd": 0, "graph_block_bwd": 0}
# the device cache: one image gather writes the model's node rows and
# boxes; the standalone F and G do not run
CACHE_STEP_LAUNCHES = {**TRAIN_STEP_LAUNCHES, "gather_image_rows": 1}
# the merged block (ModelConfig.merged_block) replaces C and D by H and I
MERGED_STEP_LAUNCHES = {**CACHE_STEP_LAUNCHES, "edge_aggregate_fwd_res": 0,
                        "edge_aggregate_bwd": 0, "graph_block_fwd": 1,
                        "graph_block_bwd": 1}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def norm_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|."""
    got, want = got.float(), want.float()
    scale = max(float(want.abs().max()), 1e-12)
    return float((got - want).abs().max()) / scale


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


# ---------------- inputs ----------------


def random_boxes(b: int, k: int, gen: torch.Generator) -> torch.Tensor:
    xy1 = torch.rand(b, k, 2, generator=gen) * 0.5
    wh = 0.05 + torch.rand(b, k, 2, generator=gen) * 0.45
    return torch.cat([xy1, xy1 + wh], dim=-1)


def edge_inputs(b, k, m, n, d, use_alpha, gen, dev):
    """Kernel A's inputs as the model makes them: sel from a top-m
    selection, pseudo from box centres, gparams from the init ranges."""
    alpha, mask = masked_neighbourhood(torch.randn(b, k, k, generator=gen),
                                       m)
    pseudo = polar_pseudo_coords(bbox_centres(random_boxes(b, k, gen)))
    proj = torch.randn(b, k, n * d, generator=gen)
    gparams = torch.stack([
        torch.rand(n, generator=gen),
        (torch.rand(n, generator=gen) * 2 - 1) * math.pi,
        torch.rand(n, generator=gen), torch.rand(n, generator=gen)])
    sel = alpha if use_alpha else mask
    return [t.contiguous().to(dev) for t in (sel, pseudo, proj, gparams)]


def gru_inputs(b, t, e, h, gen, dev):
    """Kernel B's inputs: xp from embeddings through W_ih, torch-default
    GRU weights, qlen spread over 1..T."""
    bound = 1.0 / math.sqrt(h)

    def u(*shape):
        return (torch.rand(*shape, generator=gen) * 2 - 1) * bound

    emb = torch.randn(b, t, e, generator=gen)
    w_ih, w_hh, b_ih, b_hh = u(3 * h, e), u(3 * h, h), u(3 * h), u(3 * h)
    qlen = (torch.arange(b) % t + 1).to(torch.int32)
    xp = input_projection(emb, w_ih, b_ih, torch.float32)
    return ([x.contiguous().to(dev) for x in (xp, w_hh, b_hh, qlen)],
            (emb.to(dev), w_ih.to(dev), b_ih.to(dev)))


# ---------------- timing and bounds ----------------


def time_ms(fn, samples: int = 50, reps: int = 10) -> float:
    """Median over `samples` of the mean time of `reps` back-to-back
    calls, from CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def sleep_cycles_per_ms() -> float:
    """Clock cycles of torch.cuda._sleep per ms on this card (measured
    once, on events: one launch, so no enqueue is in it)."""
    if not hasattr(sleep_cycles_per_ms, "rate"):
        torch.cuda._sleep(1_000_000)  # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(100_000_000)
        end.record()
        end.synchronize()
        sleep_cycles_per_ms.rate = 1e8 / start.elapsed_time(end)
    return sleep_cycles_per_ms.rate


def time_device_ms(fn, samples: int = 50, reps: int = 10) -> float:
    """time_ms with each sample's launches queued behind a sleep kernel,
    so that the host's time to enqueue them is hidden: the device time
    per call of a call shorter than its own enqueue. The sleep lasts
    twice the host time of one sample's enqueue, plus 1 ms; a sample
    whose enqueue still outlasted its sleep (the host was descheduled)
    is taken again behind a sleep twice as long, up to four times. A
    sample still uncovered then is kept and reported, since its time
    holds host time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    hold_ms = 2 * enqueue_ms + 1
    times, uncovered = [], 0
    for _ in range(samples):
        for attempt in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            hold = hold_ms * 2 ** attempt
            t0 = time.perf_counter()
            torch.cuda._sleep(int(hold * sleep_cycles_per_ms()))
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            covered = (time.perf_counter() - t0) * 1e3 < 0.9 * hold
            end.synchronize()
            if covered:
                break
        uncovered += not covered
        times.append(start.elapsed_time(end) / reps)
    if uncovered:
        print(f"time_device_ms: {uncovered} of {samples} samples of "
              f"{getattr(fn, '__qualname__', fn)} held the host's enqueue",
              flush=True)
    return statistics.median(times)


def bound(nbytes: float, ops_s: float):
    """(ms, "bytes"|"operations"): the larger of the two least times."""
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_bytes, ops_s) * 1e3,
            "bytes" if t_bytes >= ops_s else "operations")


def edge_bound(sel, pseudo, proj, gparams):
    b, k, nd = proj.shape
    n = gparams.shape[1]
    nbytes = (sel.numel() * 4 + pseudo.numel() * 4 + gparams.numel() * 4
              + 2 * proj.numel() * proj.element_size())
    ops_s = (2 * b * k * k * nd / PEAK_FLOPS[proj.dtype]
             + GAUSS_FLOPS * b * k * k * n / PEAK_FLOPS[torch.float32])
    return nbytes, ops_s


def gru_bound(xp, w_hh, b_hh, qlen):
    t, b, h3 = xp.shape
    h = h3 // 3
    nbytes = (xp.numel() * 4 + w_hh.numel() * w_hh.element_size()
              + b_hh.numel() * 4 + qlen.numel() * 4 + b * h * 4)
    steps = int(qlen.clamp(max=t).sum())  # rows past qlen need no work
    ops_s = (2 * steps * h * h3 / PEAK_FLOPS[w_hh.dtype]
             + GATE_FLOPS * steps * h / PEAK_FLOPS[torch.float32])
    return nbytes, ops_s


# ---------------- phases ----------------

# the VQA and medical shapes of the two convolutions: (B, K, m, n, d,
# sel is alpha (conv1, dropout in training) or the 0/1 mask (conv2))
def edge_shapes(b_vqa):
    return [(b_vqa, 36, 16, 8, 256, True, "vqa conv1"),
            (b_vqa, 36, 16, 8, 128, False, "vqa conv2"),
            (8, 51, 19, 8, 256, True, "medical conv1"),
            (8, 51, 19, 8, 128, False, "medical conv2")]


# the edges of the bf16 mma body's shapes: K = 1, 17 and 64 (rows padded
# to 16, 32, 64, ragged), n = 1 and 8, B = 1 and 257, d = 40 (rows of 80
# bytes: 16-byte multiples, not 64-column multiples)
EDGE_SHAPES_EXTRA = [(1, 1, 1, 8, 256, True, "K=1"),
                     (257, 1, 1, 1, 40, False, "K=1 n=1 d=40"),
                     (1, 17, 8, 1, 40, True, "K=17 n=1 d=40"),
                     (257, 17, 8, 8, 128, False, "K=17"),
                     (1, 64, 16, 8, 256, True, "K=64"),
                     (257, 64, 16, 1, 40, True, "K=64 n=1 d=40"),
                     (TRAIN_B, 36, 16, 8, 40, True, "d=40")]
# bf16 shapes that the rule sends to the SIMT bodies: K past 64 (A and C
# only: kernel D takes K <= 64) and rows of d = 36 bf16 (72 bytes, not a
# 16-byte multiple)
EDGE_SHAPES_SIMT = [(8, 72, 16, 8, 128, True, "K=72"),
                    (8, 36, 16, 8, 36, True, "d=36 conv1"),
                    (8, 36, 16, 8, 36, False, "d=36 conv2")]
# The mma bodies split each weight w into hi = bf16(w) and lo =
# bf16(w - hi) and multiply in two passes, which carries w to ~2^-17 of
# itself; a bf16 output then rounds to bf16(the f32 plain value) but
# where the f32 sums' order tips a tie (~0.2% of the normal elements).
# One pass (hi alone) misses w by up to 2^-9 and ~30% round otherwise.
# The normalized 1e-2 tolerance cannot tell the two apart, this share
# can: the kernel must stay at or under it, and a one-pass control
# computed from the same inputs must land above it.
ROUNDING_SHARE = 0.02


def edge_body(proj, gp):
    b, k, nd = proj.shape
    n = gp.shape[1]
    return aggregate_kernel(proj.dtype, k, n, nd // n)


def edge_fwd_into_nan(sel, pseudo, proj, gp, relu, rate=0.0, seeds=None,
                      train=False):
    """Kernel A (or C with train) through its C entry, in the rule's
    body, into outputs filled with NaN first, so that an element left
    unwritten shows: out (or out, ghat, denom)."""
    b, k, nd = proj.shape
    n = gp.shape[1]
    code = {"simt": 0, "mma": 1}[edge_body(proj, gp)]
    dtype = 1 if proj.dtype == torch.bfloat16 else 0
    lib = _build.load("edge_aggregate")
    stream = torch.cuda.current_stream(proj.device).cuda_stream
    out = torch.full_like(proj, float("nan"))
    f32 = dict(dtype=torch.float32, device=proj.device)
    ghat = torch.full((b, n, k, k), float("nan"), **f32)
    if not train:
        _build.check(lib.edge_aggregate_fwd(
            sel.data_ptr(), pseudo.data_ptr(), proj.data_ptr(),
            gp.data_ptr(), out.data_ptr(), ghat.data_ptr(), b, k, n,
            nd // n, int(relu), dtype, code, stream), "edge_aggregate_fwd")
        return out
    denom = torch.full((b, k, k), float("nan"), **f32)
    drop = rate > 0
    _build.check(lib.edge_aggregate_fwd_res(
        sel.data_ptr(), pseudo.data_ptr(), proj.data_ptr(), gp.data_ptr(),
        seeds.data_ptr() if drop else None, out.data_ptr(), ghat.data_ptr(),
        denom.data_ptr(), b, k, n, nd // n, int(relu),
        keep_threshold(rate) if drop else 0,
        1.0 / (1.0 - rate) if drop else 1.0, dtype, code, stream),
        "edge_aggregate_fwd_res")
    return out, ghat, denom


def edge_bwd_into_nan(g, sel, ghat, denom, pseudo, proj, gp, out, rate):
    """Kernel D through its C entry, in the rule's body, into outputs and
    a G scratch filled with NaN first: (dsel, dpseudo, dproj,
    dgparams)."""
    b, k, nd = proj.shape
    n = gp.shape[1]
    code = {"simt": 0, "mma": 1}[edge_body(proj, gp)]
    lib = _build.load("edge_aggregate_bwd")
    f32 = dict(dtype=torch.float32, device=proj.device)
    ge = torch.full((b, n, k, k), float("nan"), **f32)
    dsel = torch.full((b, k, k), float("nan"), **f32)
    dpseudo = torch.full((b, k, k, 2), float("nan"), **f32)
    dproj = torch.full_like(proj, float("nan"))
    dgp_part = torch.full((b * lib.edge_aggregate_bwd_tiles(k), 4, n),
                          float("nan"), **f32)
    stream = torch.cuda.current_stream(proj.device).cuda_stream
    _build.check(lib.edge_aggregate_bwd(
        g.data_ptr(), sel.data_ptr(), ghat.data_ptr(), denom.data_ptr(),
        pseudo.data_ptr(), proj.data_ptr(), gp.data_ptr(),
        out.data_ptr() if out is not None else None, ge.data_ptr(),
        dsel.data_ptr(), dpseudo.data_ptr(), dproj.data_ptr(),
        dgp_part.data_ptr(), b, k, n, nd // n,
        1.0 / (1.0 - rate) if rate > 0 else 1.0,
        1 if proj.dtype == torch.bfloat16 else 0, code, stream),
        "edge_aggregate_bwd")
    return dsel, dpseudo, dproj, dgp_part.sum(dim=0)


def rounding_share(got, want):
    """The share of want's normal elements that got does not equal: for
    a bf16 output and want = bf16(the f32 plain value), the share that
    the kernel rounded otherwise. Zeros and subnormals (below 2^-126,
    where narrow Gaussians put a few percent of the outputs) are left
    out: there the mma body and the plain f32 sums part at absolute
    differences under 2^-126, which says nothing of the weights'
    precision and which the normalized check covers."""
    normal = want.abs() >= torch.finfo(torch.bfloat16).tiny
    return float((got != want)[normal].float().mean())


def one_pass_weights(sel, ghat):
    """The control's weights: w = sel * ghat rounded once to bf16."""
    return (sel[:, None] * ghat).to(torch.bfloat16).float()


def one_pass_out(sel, ghat, proj, rate=0.0, seeds=None):
    """The forward with one bf16 pass of the weights (the control of the
    hi/lo split): f32 sums, relu, the plain Philox dropout, bf16."""
    b, k, nd = proj.shape
    n = ghat.shape[1]
    acc = torch.einsum("bnij,bjnd->bind", one_pass_weights(sel, ghat),
                       proj.float().reshape(b, k, n, nd // n))
    acc = torch.relu(acc.reshape(b, k, nd))
    if rate:
        keep = philox_keep(seeds, acc.shape[1:], rate)
        acc = torch.where(keep, acc * (1.0 / (1.0 - rate)),
                          torch.zeros_like(acc))
    return acc.to(torch.bfloat16)


def one_pass_dproj(g, sel, ghat, out, rate):
    """Kernel D's dproj with one bf16 pass of the weights (the
    control)."""
    b, k, nd = g.shape
    n = ghat.shape[1]
    inv_keep = 1.0 / (1.0 - rate) if rate else 1.0
    gm = torch.where(out.float() > 0, g.float() * inv_keep,
                     torch.zeros(g.shape, device=g.device))
    return torch.einsum("bnij,bind->bjnd", one_pass_weights(sel, ghat),
                        gm.reshape(b, k, n, nd // n)).reshape(
                            b, k, nd).to(torch.bfloat16)


def split_check(label, shares, controls):
    """The hi/lo split on the card: each bf16 share at or under
    ROUNDING_SHARE, and each one-pass control (given at the main path's
    shapes) above it."""
    print(f"  {label} hi/lo split: share rounded otherwise than "
          f"bf16(f32 plain) " + ", ".join(f"{k} {v:.5f}"
                                          for k, v in shares.items())
          + f" (<= {ROUNDING_SHARE}); one-pass control "
          + (", ".join(f"{k} {v:.5f}" for k, v in controls.items())
             + f" (> {ROUNDING_SHARE})" if controls else "not run here"),
          flush=True)
    require(all(v <= ROUNDING_SHARE for v in shares.values()),
            f"{label}: a bf16 output rounds as one pass of the weights")
    require(all(v > ROUNDING_SHARE for v in controls.values()),
            f"{label}: the one-pass control does not fail the share check")


def edge_check_shapes(b_main):
    """(shape, control): the main path's shapes, where the one-pass
    control runs, then the mma body's edge shapes and the SIMT shapes."""
    return ([(x, True) for x in edge_shapes(b_main)]
            + [(x, False) for x in EDGE_SHAPES_EXTRA + EDGE_SHAPES_SIMT])


def check_edge_forward(dev, gen, errs):
    """Phase 3, kernel A: f32 (SIMT body, 1e-5) and bf16 (the rule's body,
    1e-2), normalized, against the plain version at the serving shapes,
    the medical K=51, m=19, the mma body's edge shapes and the bf16
    shapes the rule sends to the SIMT body; the rule's pick asserted; the
    bf16 body run again into NaN-filled outputs must give the same bits;
    and for the mma body the hi/lo split's rounding share."""
    for shape, control in edge_check_shapes(SERVE_B):
        check_edge_forward_shape(shape, control, gen, dev, errs)


def check_edge_forward_shape(shape, control, gen, dev, errs):
    """check_edge_forward at one (B, K, m, n, d, conv1, label) shape; the
    one-pass control runs where ``control``."""
    b, k, m, n, d, use_alpha, label = shape
    sel, pseudo, proj, gp = edge_inputs(b, k, m, n, d, use_alpha, gen, dev)
    want = "mma" if k <= 64 and d % 8 == 0 else "simt"
    require(aggregate_kernel(torch.bfloat16, k, n, d) == want
            and aggregate_kernel(torch.float32, k, n, d) == "simt",
            f"the aggregation rule at K={k} d={d}")
    out = fused_sel_aggregate_act(sel, pseudo, proj, gp, relu=True)
    ref = sel_aggregate_act_reference(sel, pseudo, proj, gp, relu=True)
    torch.cuda.synchronize()
    e32 = norm_err(out, ref)
    proj16 = proj.to(torch.bfloat16)
    out16 = fused_sel_aggregate_act(sel, pseudo, proj16, gp, relu=True)
    ref16 = sel_aggregate_act_reference(
        sel, pseudo, proj16.float(), gp, relu=True).to(torch.bfloat16)
    again = edge_fwd_into_nan(sel, pseudo, proj16, gp, True)
    torch.cuda.synchronize()
    e16 = norm_err(out16, ref16)
    same = torch.equal(out16, again)
    print(f"kernel A {label} B={b} K={k} n={n} d={d}: normalized err f32 "
          f"{e32:.3e} (<= 1e-5), bf16 {want} {e16:.3e} (<= 1e-2); "
          f"NaN-filled rerun equal bit for bit {same}", flush=True)
    require(out16.dtype == torch.bfloat16 and out.shape == ref.shape,
            "kernel A output dtype/shape")
    require(e32 <= 1e-5 and e16 <= 1e-2 and same,
            f"kernel A {label} disagrees")
    if want == "mma":
        controls = {}
        if control:
            ghat = sel_aggregate_act_residuals_reference(
                sel, pseudo, proj16, gp)[1]
            controls["out"] = rounding_share(
                one_pass_out(sel, ghat, proj16), ref16)
        split_check(f"kernel A {label}",
                    {"out": rounding_share(out16, ref16)}, controls)
    if label == "vqa conv1":
        errs["edge_aggregate_fwd"] = float(
            (out16.float() - ref16.float()).abs().max())


def check_kernels(dev, gen):
    """Phase 3: each kernel against its plain version on the card."""
    errs = {}
    check_edge_forward(dev, gen, errs)
    # kernel B: T=16, H=1024, the persistent kernel (bf16 weights) and
    # the per-step one (f32) at B = 1, 16, 64, 200 (a ragged second batch
    # half) and 256, qlen spread over 0..T (0 and T included) and all
    # equal to T; a second run must give the same bits
    t = FULL["max_qlen"]
    for b in (1, SERVE_B, TRAIN_B, 200, 256):
        require(scan_kernel(torch.bfloat16, b, 1024) == "persistent"
                and scan_kernel(torch.float32, b, 1024) == "per_step",
                f"kernel B's rule at B={b}")
        (xp, w_hh, b_hh, _), _ = gru_inputs(b, t, 300, 1024, gen, dev)
        spread = torch.arange(b) % (t + 1)
        spread[:2] = torch.tensor([0, t])[:b]
        for label, qlen in (("spread", spread),
                            ("all T", torch.full((b,), t))):
            qlen = qlen.to(dev, torch.int32)
            e_b, same = [], []
            for w in (w_hh, w_hh.to(torch.bfloat16)):
                h = gru_scan(xp, w, b_hh, qlen)
                again = gru_scan(xp, w, b_hh, qlen)
                ref = gru_scan_reference(xp, w, b_hh, qlen)
                torch.cuda.synchronize()
                e_b.append(float((h - ref).abs().max()))
                same.append(torch.equal(h, again))
            print(f"kernel B B={b} T={t} H=1024 qlen {label}: max abs err "
                  f"f32 per-step {e_b[0]:.3e} (<= 1e-5), bf16 persistent "
                  f"{e_b[1]:.3e} (<= 2e-3); second run equal bit for bit "
                  f"{same}", flush=True)
            require(e_b[0] <= 1e-5 and e_b[1] <= 2e-3 and all(same),
                    f"kernel B B={b} qlen {label} disagrees")
            if b == SERVE_B and label == "spread":
                errs["gru_scan_fwd"] = e_b[1]
    # the rest of kernel B's bf16 rule: the persistent kernel's 96-wide K
    # chunks (B = 129..160), narrower widths, and the per-step kernel
    # past 256 rows
    for b, h in ((150, 1024), (16, 128), (150, 256), (257, 1024)):
        want = "per_step" if b > 256 else "persistent"
        require(scan_kernel(torch.bfloat16, b, h) == want,
                f"kernel B's rule at B={b} H={h}")
        (xp, w_hh, b_hh, _), _ = gru_inputs(b, t, 300, h, gen, dev)
        w16 = w_hh.to(torch.bfloat16)
        qlen = (torch.arange(b) % (t + 1)).to(dev, torch.int32)
        out = gru_scan(xp, w16, b_hh, qlen)
        again = gru_scan(xp, w16, b_hh, qlen)
        ref = gru_scan_reference(xp, w16, b_hh, qlen)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        same = torch.equal(out, again)
        print(f"kernel B B={b} T={t} H={h} bf16 {want}, qlen spread: max "
              f"abs err {err:.3e} (<= 2e-3); second run equal bit for bit "
              f"{same}", flush=True)
        require(err <= 2e-3 and same, f"kernel B B={b} H={h} disagrees")
    return errs


def random_batch(b, cfg, gen):
    q = torch.randint(1, cfg.vocab_size, (b, cfg.max_qlen), generator=gen)
    qlen = torch.randint(3, 15, (b,), generator=gen).to(torch.int32)
    feats = torch.randn(b, cfg.n_obj, cfg.feat_dim - 4, generator=gen)
    image = torch.cat([feats, random_boxes(b, cfg.n_obj, gen)], dim=-1)
    return q, image, qlen


def full_width_forward(dev, gen):
    """Phase 4: the port on the card against the port on the CPU."""
    cfg32 = ModelConfig(**FULL, compute_dtype="float32")
    cpu = GraphVQAModel(cfg32, device="cpu", seed=SEED)
    gpu = GraphVQAModel(cfg32, device=dev, seed=SEED)
    gpu.load_state_dict(cpu.state_dict())
    q, image, qlen = random_batch(SERVE_B, cfg32, gen)
    logits_c, adj_c, _ = cpu(q, image, qlen)
    a0, b0 = fused_sel_aggregate_act.launches, gru_scan.launches
    logits_g, adj_g, hmax_g = gpu(q.to(dev), image.to(dev), qlen.to(dev))
    torch.cuda.synchronize()
    da = fused_sel_aggregate_act.launches - a0
    db = gru_scan.launches - b0
    require(da == 2 and db == cfg32.max_qlen,
            f"launches per forward: A {da} (want 2), B {db} (want "
            f"{cfg32.max_qlen})")
    el, ea = norm_err(logits_g.cpu(), logits_c), norm_err(adj_g.cpu(), adj_c)
    same = bool((logits_g.argmax(-1).cpu() == logits_c.argmax(-1)).all())
    print(f"full width f32, card vs CPU: logits {el:.3e}, adjacency "
          f"{ea:.3e} (<= 1e-4), argmax identical {same}; launches per "
          f"forward A={da} B={db}", flush=True)
    require(tuple(logits_g.shape) == (SERVE_B, cfg32.out_dim)
            and tuple(hmax_g.shape) == (SERVE_B, cfg32.hid_dim),
            "output shapes")
    require(bool(torch.isfinite(logits_g).all()), "non-finite logits")
    require(el <= 1e-4 and ea <= 1e-4 and same, "f32 forward disagrees")

    cfg16 = ModelConfig(**FULL)  # the default: bf16 compute
    bf16 = GraphVQAModel(cfg16, device=dev, seed=SEED)
    bf16.load_state_dict(cpu.state_dict())
    logits_b, _, _ = bf16(q.to(dev), image.to(dev), qlen.to(dev))
    agree = float((logits_b.argmax(-1).cpu()
                   == logits_c.argmax(-1)).float().mean())
    print(f"full width bf16 on card vs f32 CPU: argmax agreement "
          f"{agree:.4f} (>= 0.5), logits {norm_err(logits_b.cpu(), logits_c):.3e}",
          flush=True)
    require(agree >= 0.5, "bf16 argmax agreement below 0.5")
    return bf16


class ServingData:
    """The duck-typed dataset InferenceServer reads: vocabularies and a
    FeatureStore of random images (ids "100".."163")."""

    def __init__(self, cfg: ModelConfig, n_images: int, seed: int):
        rng = np.random.default_rng(seed)
        self.q_wtoi = {f"w{i}": i for i in range(1, cfg.vocab_size)}
        self.a_itow = {i: f"answer{i}" for i in range(cfg.out_dim - 1)}
        self.n_answers = cfg.out_dim
        self.max_qlen, self.n_obj = cfg.max_qlen, cfg.n_obj
        self.feat_dim = cfg.feat_dim
        feats = rng.normal(size=(n_images, cfg.n_obj, cfg.feat_dim - 4))
        xy1 = rng.uniform(0, 0.5, size=(n_images, cfg.n_obj, 2))
        wh = rng.uniform(0.05, 0.5, size=(n_images, cfg.n_obj, 2))
        boxes = np.concatenate([xy1, xy1 + wh], -1)
        self.store = FeatureStore(
            feats.astype(np.float32), boxes.astype(np.float32),
            {str(100 + i): i for i in range(n_images)})


def serving_jobs(words, image_ids, n, seed):
    """n (question, image id) requests: 3-13 random words each and the
    image ids in turn."""
    rng = np.random.default_rng(seed)
    jobs = []
    for i in range(n):
        picks = rng.integers(0, len(words), int(rng.integers(3, 14)))
        jobs.append((" ".join(words[int(w)] for w in picks) + " ?",
                     image_ids[i % len(image_ids)]))
    return jobs


def http_serve(srv, jobs, n_clients=8):
    """``jobs`` as POST /predict requests from ``n_clients`` keep-alive
    clients to ``srv`` behind its HTTP front-end on port 0. Returns
    (answers by job index, latencies in s, /healthz, wall s); fails on
    any failed request."""
    httpd = make_http_server(srv, port=0)
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    host, port = httpd.server_address[:2]
    answers, latencies, failures = {}, [], []
    lock = threading.Lock()

    def client(c):
        conn = http.client.HTTPConnection(host, port, timeout=120)
        try:
            for i in range(c, len(jobs), n_clients):
                question, iid = jobs[i]
                t0 = time.perf_counter()
                conn.request("POST", "/predict", body=json.dumps(
                    {"question": question, "image_id": iid}))
                resp = conn.getresponse()
                body = json.loads(resp.read())
                with lock:
                    latencies.append(time.perf_counter() - t0)
                    if resp.status != 200:
                        failures.append((i, resp.status, body))
                    else:
                        answers[i] = body["answer"]
        except Exception as e:  # reported below; the phase then fails
            with lock:
                failures.append((c, "client", repr(e)))
        finally:
            conn.close()

    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    try:
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        wall = time.perf_counter() - t0
        require(not any(c.is_alive() for c in clients), "clients hung")
        conn = http.client.HTTPConnection(host, port, timeout=30)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
    require(not failures, f"failed requests: {failures[:3]}")
    require(len(answers) == len(jobs), "missing answers")
    return answers, sorted(latencies), health, wall


def p50_p99(lat):
    """(p50, p99) in ms of sorted latencies in s."""
    return (1e3 * lat[len(lat) // 2],
            1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))])


def direct_top1(model, ds, jobs, dev, b):
    """Each job's answer from a direct forward of padded batches of b
    rows, as the server pads them."""
    t, k, fdim = ds.max_qlen, ds.n_obj, ds.feat_dim
    out = []
    for s in range(0, len(jobs), b):
        chunk = jobs[s:s + b]
        q = np.zeros((b, t), np.int64)
        qlen = np.ones((b,), np.int32)
        image = np.zeros((b, k, fdim), np.float32)
        for i, (question, iid) in enumerate(chunk):
            words = tokenize(question)[:t]
            q[i, :len(words)] = [ds.q_wtoi.get(w, 0) for w in words]
            qlen[i] = max(1, len(words))
            row = ds.store.id_to_row[iid]
            image[i, :, :fdim - 4] = ds.store.features[row]
            image[i, :, fdim - 4:] = ds.store.boxes[row]
        with torch.inference_mode():
            logits, _, _ = model(torch.from_numpy(q).to(dev),
                                 torch.from_numpy(image).to(dev),
                                 torch.from_numpy(qlen).to(dev))
            logits[:, -1] = float("-inf")
            top1 = logits.argmax(-1).cpu().numpy()
        out += [ds.a_itow[int(top1[i])] for i in range(len(chunk))]
    return out


def serve(model, dev, n_clients=8, per_client=8):
    """Phase 5, the main path: HTTP -> InferenceServer -> forward."""
    ds = ServingData(model.cfg, 64, SEED)
    jobs = serving_jobs([f"w{i}" for i in range(1, model.cfg.vocab_size)],
                        [str(100 + i) for i in range(64)],
                        n_clients * per_client, SEED + 1)
    reset_counts()
    srv = InferenceServer(model, ds, device=dev, batch_size=SERVE_B,
                          max_wait_ms=5.0)
    try:
        answers, lat, health, wall = http_serve(srv, jobs, n_clients)
    finally:
        srv.close()
    launches = {"edge_aggregate_fwd": fused_sel_aggregate_act.launches,
                "gru_scan_fwd": gru_scan.launches}
    p50, p99 = p50_p99(lat)
    print(f"serving: {len(jobs)} requests from {n_clients} keep-alive "
          f"clients in {wall:.3f} s, {health['batches_served']} batches, "
          f"latency p50 {p50:.2f} ms p99 {p99:.2f} ms, "
          f"warmup_s {srv.warmup_s:.3f}; launches {launches}", flush=True)
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the path never launched: {launches}")

    # every answer against a direct forward of the same padded shape
    want = direct_top1(model, ds, jobs, dev, SERVE_B)
    mismatches = sum(answers[i] != want[i] for i in range(len(jobs)))
    print(f"serving answers equal to a direct forward: "
          f"{len(jobs) - mismatches}/{len(jobs)}", flush=True)
    require(mismatches == 0, "served answers differ from the forward")
    return launches


def random_seeds(b, gen, dev):
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (b,), generator=gen,
                         dtype=torch.int32).to(dev)


def check_edge_training(dev, gen, errs):
    """Phase 7, kernels C and D: every output against the plain version
    on the same inputs (D under the kernel's own dropout mask), f32 (SIMT
    body: C 1e-5, D 1e-4) and bf16 (the rule's body, 1e-2), normalized,
    at the VQA shapes (B=64), the medical K=51, m=19 (B=8), the mma
    body's edge shapes and the bf16 shapes the rule sends to the SIMT
    bodies (D only at K <= 64, all it takes); the bf16 bodies run again
    into NaN-filled outputs must give the same bits; for the mma bodies
    the hi/lo split's rounding share of out and dproj; and the dropout
    epilogue's bits, rate, repeatability and per-image seeds in both
    dtypes."""
    for shape, control in edge_check_shapes(TRAIN_B):
        check_edge_training_shape(shape, control, gen, dev, errs)


def check_edge_training_shape(shape, control, gen, dev, errs,
                              dropout=DROPOUT):
    """check_edge_training at one (B, K, m, n, d, conv1, label) shape,
    conv1 at the rate ``dropout``; the one-pass controls run where
    ``control``."""
    b, k, m, n, d, use_alpha, label = shape
    sel, pseudo, proj, gp = edge_inputs(b, k, m, n, d, use_alpha, gen, dev)
    # conv1 runs relu + dropout in training, conv2 relu only
    rate = dropout if use_alpha else 0.0
    seeds = random_seeds(b, gen, dev) if rate else None
    g = torch.randn(proj.shape, generator=gen).to(dev)
    with_d = k <= 64
    for dtype, tol_c, tol_d in ((torch.float32, 1e-5, 1e-4),
                                (torch.bfloat16, 1e-2, 1e-2)):
        p = proj.to(dtype)
        body = edge_body(p, gp)
        res = sel_aggregate_act_residuals(sel, pseudo, p, gp, True, rate,
                                          seeds)
        ref = sel_aggregate_act_residuals_reference(sel, pseudo, p, gp,
                                                    True, rate, seeds)
        grads = ref_g = ()
        if with_d:
            grads = sel_aggregate_act_vjp(g.to(dtype), sel, res[1],
                                          res[2], pseudo, p, gp, res[0],
                                          rate)
            ref_g = sel_aggregate_act_vjp_reference(
                g.to(dtype), sel, res[1], res[2], pseudo, p, gp, res[0],
                rate)
        same = True
        if dtype == torch.bfloat16:
            res2 = edge_fwd_into_nan(sel, pseudo, p, gp, True, rate,
                                     seeds, train=True)
            grads2 = (edge_bwd_into_nan(g.to(dtype), sel, res[1], res[2],
                                        pseudo, p, gp, res[0], rate)
                      if with_d else ())
            torch.cuda.synchronize()
            same = (all(torch.equal(x, y) for x, y in zip(res, res2))
                    and all(torch.equal(x, y)
                            for x, y in zip(grads, grads2)))
        torch.cuda.synchronize()
        e_c = [norm_err(x, y) for x, y in zip(res, ref)]
        e_d = [norm_err(x, y) for x, y in zip(grads, ref_g)]
        print(f"kernel C {label} B={b} K={k} n={n} d={d} "
              f"{str(dtype)[6:]} {body} dropout {rate}: normalized err "
              f"out/ghat/denom {e_c[0]:.2e}/{e_c[1]:.2e}/{e_c[2]:.2e} "
              f"(<= {tol_c}); kernel D dsel/dpseudo/dproj/dgparams "
              + ("/".join(f"{e:.2e}" for e in e_d) + f" (<= {tol_d})"
                 if with_d else "not run (K > 64)")
              + f"; NaN-filled reruns equal bit for bit {same}",
              flush=True)
        require(max(e_c) <= tol_c, f"kernel C {label} disagrees")
        require(max(e_d, default=0.0) <= tol_d,
                f"kernel D {label} disagrees")
        require(same, f"kernels C/D {label}: a rerun changed bits")
        if body == "mma":
            g16 = g.to(dtype)
            controls = {}
            if control:
                controls = {
                    "out": rounding_share(one_pass_out(
                        sel, ref[1], p, rate, seeds), ref[0]),
                    "dproj": rounding_share(one_pass_dproj(
                        g16, sel, res[1], res[0], rate), ref_g[2])}
            split_check(f"kernels C/D {label}",
                        {"out": rounding_share(res[0], ref[0]),
                         "dproj": rounding_share(grads[2], ref_g[2])},
                        controls)
        if label == "vqa conv1" and dtype == torch.bfloat16:
            errs["edge_aggregate_fwd_res"] = max(
                float((x.float() - y.float()).abs().max())
                for x, y in zip(res, ref))
            errs["edge_aggregate_bwd"] = max(
                float((x.float() - y.float()).abs().max())
                for x, y in zip(grads, ref_g))
        if rate and b > 1:
            check_dropout(sel, pseudo, p, gp, seeds, res[0],
                          f"{label} {str(dtype)[6:]}", rate)


def check_dropout(sel, pseudo, proj, gp, seeds, out, label, rate=DROPOUT):
    """Kernel C's dropout mask: bit for bit the plain Philox keep mask
    wherever the relu output is clear of 0, 1 - rate of the positive
    units kept, the same seeds giving the same output, and a changed seed
    changing its own image only. Clear of 0: above 1e-6 of the largest
    output in f32; above 1e-3 in bf16, where the product's operands are
    rounded to bf16 (hi + lo) and a unit within that of 0 may take the
    other side of the relu."""
    plain = sel_aggregate_act_residuals_reference(sel, pseudo, proj, gp,
                                                  True)[0]
    keep = philox_keep(seeds, proj.shape[1:], rate)
    margin = 1e-6 if proj.dtype == torch.float32 else 1e-3
    clear = plain > margin * float(plain.max())
    mismatched = int(((out != 0) != keep)[clear].sum())
    kept = float((out > 0).sum()) / float((plain > 0).sum())
    again = sel_aggregate_act_residuals(sel, pseudo, proj, gp, True,
                                        rate, seeds)[0]
    seeds2 = seeds.clone()
    seeds2[1] ^= 1
    other = sel_aggregate_act_residuals(sel, pseudo, proj, gp, True,
                                        rate, seeds2)[0]
    changed = [i for i in range(out.shape[0])
               if not torch.equal(other[i], out[i])]
    torch.cuda.synchronize()
    print(f"kernel C {label} dropout: mask mismatches vs plain Philox "
          f"{mismatched} of {int(clear.sum())} (want 0); kept fraction of "
          f"positive units {kept:.5f} ({1 - rate} +- 0.005); repeat identical "
          f"{torch.equal(again, out)}; seed of image 1 changed -> images "
          f"changed {changed}", flush=True)
    require(mismatched == 0, "dropout mask differs from the plain Philox")
    require(abs(kept - (1 - rate)) <= 0.005,
            f"kept fraction off {1 - rate}")
    require(torch.equal(again, out), "same seeds, different output")
    require(changed == [1], "a seed change leaked across images")


def check_gru_training(dev, gen, errs):
    """Phase 7, kernel B's states and hp and kernel E (sweep, then dW/db),
    each against its plain version on the same inputs, at T=16. bf16 at
    H=1024 and B = 1, 8, 50 (R = 750 rows, not a multiple of the weight
    gradient's 64-row K step), 64, 150, 200 and 256 (past 16 rows the
    sweep splits the batch over two blocks), qlen spread over 0..T and
    all equal to T: check_bf16_sweep. f32 at B = 8, 50, 64, 256: the
    per-step sweep (T launches) and the SIMT weight gradient. Then bf16
    at the narrow widths H = 64, 128, 192, 256 (B = 8, 50), and the
    bf16 shapes the rule sends to the per-step sweep."""
    t = FULL["max_qlen"]
    for b in (1, 8, 50, TRAIN_B, 150, 200, 256):
        (xp, w_hh, b_hh, _), _ = gru_inputs(b, t, 300, 1024, gen, dev)
        w16 = w_hh.to(torch.bfloat16)
        spread = torch.arange(b) % (t + 1)
        spread[:2] = torch.tensor([0, t])[:b]
        for label, qlen in (("spread", spread),
                            ("all T", torch.full((b,), t))):
            qlen = qlen.to(dev, torch.int32)
            e = check_bf16_sweep(xp, w16, b_hh, qlen, gen,
                                 f"B={b} H=1024 qlen {label}")
            if b == TRAIN_B and label == "spread":
                errs["gru_scan_bwd_persistent"], errs["gru_wgrad"] = e
        if b in (8, 50, TRAIN_B, 256):
            check_f32_backward(xp, w_hh, b_hh, spread.to(dev, torch.int32),
                               gen, f"B={b} H=1024")
    # the narrow widths the rules admit: one or two row tiles of the
    # weight gradient, a column tile past H (H = 64, 192), db spread over
    # few blocks (192 columns a block at H = 64 and 128), one chunk of
    # dhp per sweep step (H = 64)
    for h in (64, 128, 192, 256):
        for b in (8, 50):
            (xp, w_hh, b_hh, qlen), _ = gru_inputs(b, t, 300, h, gen, dev)
            check_bf16_sweep(xp, w_hh.to(torch.bfloat16), b_hh, qlen, gen,
                             f"B={b} H={h}")
    # bf16 past the persistent sweep's shapes: more than 256 rows, and a
    # width that is not a multiple of 64
    for b, h in ((257, 1024), (8, 1032)):
        (xp, w_hh, b_hh, qlen), _ = gru_inputs(b, t, 300, h, gen, dev)
        check_bf16_per_step(xp, w_hh.to(torch.bfloat16), b_hh, qlen, gen,
                            f"B={b} H={h}")


def check_bf16_sweep(xp, w16, b_hh, qlen, gen, label):
    """Kernel B's persistent training forward and kernel E with bf16
    weights: hs16 equal to hs in bf16 bit for bit; hp within 1e-5
    normalized (f32 rounding) of hs16[t-1] @ W^T + b from cuBLAS; the
    persistent sweep, one launch, within 5e-3 normalized of its plain
    version fed the same hp (bf16 dhp: a one-unit rounding flip is
    3.9e-3 of the largest value) and of the recomputing plain version;
    a second run and a run into NaN-filled outputs equal bit for bit;
    the wgmma dW/db within 1e-4 normalized of the plain product, equal
    bit for bit to a run into NaN-filled outputs. Returns the sweep's and
    dW/db's max abs errors."""
    b, h = qlen.shape[0], w16.shape[1]
    require(sweep_kernel(w16.dtype, b, h) == "persistent"
            and wgrad_kernel(w16.dtype, h) == "wgmma",
            f"kernel E's rules at B={b} H={h}")
    gh = torch.randn(b, h, generator=gen).to(xp.device)
    _, hs, hs16, hp = gru_scan(xp, w16, b_hh, qlen, return_hs=True,
                               return_hp=True)
    h_prev = torch.cat([torch.zeros_like(hs16[:1]), hs16[:-1]])
    r_hp = matmul(h_prev, w16.t()) + b_hh
    before = gru_scan_bwd.launches
    dxp, dhp = gru_scan_bwd(xp, w16, b_hh, qlen, hs, gh, hp)
    launched = gru_scan_bwd.launches - before
    dxp2, dhp2 = gru_scan_bwd(xp, w16, b_hh, qlen, hs, gh, hp)
    n_dxp, n_dhp = sweep_into_nan(xp, w16, hp, hs, qlen, gh)
    r_dxp, r_dhp = gru_scan_sweep_reference(xp, w16, b_hh, qlen, hs, gh, hp)
    c_dxp, c_dhp = gru_scan_sweep_reference(xp, w16, b_hh, qlen, hs, gh)
    dw, db = gru_wgrad(dhp, hs16)
    n_dw, n_db = wgrad_into_nan(dhp, hs16)
    r_dw, r_db = gru_wgrad_reference(dhp, hs)
    torch.cuda.synchronize()
    same16 = torch.equal(hs16, hs.to(torch.bfloat16))
    e_hp = norm_err(hp, r_hp)
    e_sweep = max(norm_err(dxp, r_dxp), norm_err(dhp, r_dhp))
    e_rec = max(norm_err(dxp, c_dxp), norm_err(dhp, c_dhp))
    repeat = (torch.equal(dxp, dxp2) and torch.equal(dhp, dhp2)
              and torch.equal(dxp, n_dxp) and torch.equal(dhp, n_dhp))
    e_w = max(norm_err(dw, r_dw), norm_err(db, r_db))
    repeat_w = torch.equal(dw, n_dw) and torch.equal(db, n_db)
    print(f"kernel B states / E bf16 {label} T={xp.shape[0]}: hs16 = hs in "
          f"bf16 {same16}; hp normalized {e_hp:.2e} (<= 1e-5); persistent "
          f"sweep ({launched} launch) dxp/dhp normalized {e_sweep:.2e} "
          f"(<= 5e-3; against the recomputing plain version {e_rec:.2e}), "
          f"second run and a run into NaN-filled outputs equal bit for bit "
          f"{repeat}; dW/db (wgmma) normalized {e_w:.2e} (<= 1e-4), a run "
          f"into NaN-filled outputs equal bit for bit {repeat_w}",
          flush=True)
    require(same16 and e_hp <= 1e-5, f"kernel B states {label} disagree")
    require(launched == 1 and e_sweep <= 5e-3 and e_rec <= 5e-3 and repeat,
            f"kernel E sweep {label} disagrees")
    require(e_w <= 1e-4 and repeat_w, f"kernel E dW/db {label} disagrees")
    return (max(float((dxp - r_dxp).abs().max()),
                float((dhp.float() - r_dhp.float()).abs().max())),
            max(float((dw - r_dw).abs().max()), float((db - r_db).abs().max())))


def check_bf16_per_step(xp, w16, b_hh, qlen, gen, label):
    """bf16 weights where the rules send them to the per-step sweep (T
    launches, hp recomputed): within 1e-2 normalized of its plain
    version, a second run equal bit for bit; then the weight gradient
    the width takes (wgmma from hs16, or SIMT from hs) within 1e-4."""
    b, h = qlen.shape[0], w16.shape[1]
    require(sweep_kernel(w16.dtype, b, h) == "per_step",
            f"kernel E's sweep rule at B={b} H={h}")
    kernel = wgrad_kernel(w16.dtype, h)
    gh = torch.randn(b, h, generator=gen).to(xp.device)
    _, hs, hs16 = gru_scan(xp, w16, b_hh, qlen, return_hs=True)
    before = gru_scan_bwd.launches
    dxp, dhp = gru_scan_bwd(xp, w16, b_hh, qlen, hs, gh)
    launched = gru_scan_bwd.launches - before
    dxp2, dhp2 = gru_scan_bwd(xp, w16, b_hh, qlen, hs, gh)
    r_dxp, r_dhp = gru_scan_sweep_reference(xp, w16, b_hh, qlen, hs, gh)
    dw, db = gru_wgrad(dhp, hs16 if kernel == "wgmma" else hs)
    r_dw, r_db = gru_wgrad_reference(dhp, hs)
    torch.cuda.synchronize()
    e_sweep = max(norm_err(dxp, r_dxp), norm_err(dhp, r_dhp))
    repeat = torch.equal(dxp, dxp2) and torch.equal(dhp, dhp2)
    e_w = max(norm_err(dw, r_dw), norm_err(db, r_db))
    print(f"kernel E bf16 per-step {label} T={xp.shape[0]}: sweep "
          f"({launched} launches) dxp/dhp normalized {e_sweep:.2e} (<= "
          f"1e-2), second run equal bit for bit {repeat}; dW/db ({kernel}) "
          f"normalized {e_w:.2e} (<= 1e-4)", flush=True)
    require(launched == xp.shape[0] and e_sweep <= 1e-2 and repeat,
            f"kernel E bf16 per-step sweep {label} disagrees")
    require(e_w <= 1e-4, f"kernel E dW/db {label} disagrees")


def check_f32_backward(xp, w_hh, b_hh, qlen, gen, label):
    """f32 weights: kernel B's per-step states within 1e-5, the per-step
    sweep (T launches) within 1e-5 normalized of its plain version, and
    the SIMT dW/db within 1e-4, repeating bit for bit."""
    b, h = qlen.shape[0], w_hh.shape[1]
    require(sweep_kernel(w_hh.dtype, b, h) == "per_step"
            and wgrad_kernel(w_hh.dtype, h) == "simt",
            "kernel E's rules for f32 weights")
    gh = torch.randn(b, h, generator=gen).to(xp.device)
    _, hs, hs16 = gru_scan(xp, w_hh, b_hh, qlen, return_hs=True)
    _, r_hs = gru_scan_reference(xp, w_hh, b_hh, qlen, return_hs=True)
    before = gru_scan_bwd.launches
    dxp, dhp = gru_scan_bwd(xp, w_hh, b_hh, qlen, hs, gh)
    launched = gru_scan_bwd.launches - before
    r_dxp, r_dhp = gru_scan_sweep_reference(xp, w_hh, b_hh, qlen, hs, gh)
    dw, db = gru_wgrad(dhp, hs)
    dw2, db2 = gru_wgrad(dhp, hs)
    r_dw, r_db = gru_wgrad_reference(dhp, hs)
    torch.cuda.synchronize()
    e_hs = float((hs - r_hs).abs().max())
    e_sweep = max(norm_err(dxp, r_dxp), norm_err(dhp, r_dhp))
    e_w = max(norm_err(dw, r_dw), norm_err(db, r_db))
    repeat = torch.equal(dw, dw2) and torch.equal(db, db2)
    print(f"kernel B states / E f32 {label} T={xp.shape[0]}: hs max abs "
          f"{e_hs:.2e} (<= 1e-5), hs16 {hs16}; per-step sweep ({launched} "
          f"launches) normalized {e_sweep:.2e} (<= 1e-5); dW/db (simt) "
          f"normalized {e_w:.2e} (<= 1e-4), second run equal bit for bit "
          f"{repeat}", flush=True)
    require(e_hs <= 1e-5 and hs16 is None, f"kernel B states {label}")
    require(launched == xp.shape[0] and e_sweep <= 1e-5,
            f"kernel E per-step sweep {label} disagrees")
    require(e_w <= 1e-4 and repeat, f"kernel E SIMT dW/db {label} disagrees")


def sweep_into_nan(xp, w16, hp, hs, qlen, gh):
    """The persistent sweep through its C entry into outputs filled with
    NaN, so that an element it leaves unwritten shows."""
    t, b, h3 = xp.shape
    dxp = torch.full_like(xp, float("nan"))
    dhp = torch.full(xp.shape, float("nan"), dtype=w16.dtype, device=xp.device)
    counter = torch.empty((1,), dtype=torch.int32, device=xp.device)
    rc = _build.load("gru_scan_bwd").gru_scan_bwd_persistent(
        xp.data_ptr(), w16.data_ptr(), hp.data_ptr(), hs.data_ptr(),
        qlen.data_ptr(), gh.data_ptr(), dxp.data_ptr(), dhp.data_ptr(),
        counter.data_ptr(), t, b, h3 // 3,
        torch.cuda.current_stream(xp.device).cuda_stream)
    _build.check(rc, "gru_scan_bwd_persistent")
    return dxp, dhp


def wgrad_into_nan(dhp, hs16):
    """The wgmma weight gradient through its C entry into outputs filled
    with NaN, so that an element it leaves unwritten shows."""
    t, b, h3 = dhp.shape
    dw = torch.full((h3, h3 // 3), float("nan"), device=dhp.device)
    db = torch.full((h3,), float("nan"), device=dhp.device)
    rc = _build.load("gru_wgrad").gru_wgrad_wgmma(
        dhp.data_ptr(), hs16.data_ptr(), dw.data_ptr(), db.data_ptr(), t, b,
        h3 // 3, torch.cuda.current_stream(dhp.device).cuda_stream)
    _build.check(rc, "gru_wgrad_wgmma")
    return dw, db


def random_train_batch(b, cfg, gen):
    """A host batch as Batcher yields it: random questions and images,
    soft answer labels on a few classes, votes, the last row padding."""
    q, image, qlen = random_batch(b, cfg, gen)
    rng = np.random.default_rng(SEED + b)
    answers = np.zeros((b, cfg.out_dim), np.float32)
    votes = np.zeros((b, cfg.out_dim), np.float32)
    for i in range(b):
        cls = rng.choice(cfg.out_dim - 1, size=3, replace=False)
        answers[i, cls] = rng.uniform(0.3, 1.0, size=3)
        votes[i, cls] = rng.integers(1, 10, size=3)
    mask = np.ones((b,), np.float32)
    mask[-1] = 0.0
    return {"question": q.numpy(), "image": image.numpy(),
            "qlen": qlen.numpy(), "answers": answers, "votes": votes,
            "mask": mask}


def train_step_card_vs_cpu(dev, gen, b=8):
    """Phase 8: one full-width f32 training step (dropout 0) on the card
    and on the CPU from the same weights and batch."""
    cfg = ModelConfig(**{**FULL, "dropout": 0.0}, compute_dtype="float32")
    cpu = GraphVQAModel(cfg, device="cpu", seed=SEED)
    gpu = GraphVQAModel(cfg, device=dev, seed=SEED)
    gpu.load_state_dict(cpu.state_dict())
    p0 = {k: v.detach().clone() for k, v in cpu.named_parameters()}
    batch = random_train_batch(b, cfg, gen)
    tcfg = TrainConfig(lr=1e-4)
    m_cpu = train_step(cpu, make_optimizer(cpu, tcfg, 10)[0], None, batch)
    reset_counts()
    m_gpu = train_step(gpu, make_optimizer(gpu, tcfg, 10)[0], None, batch)
    torch.cuda.synchronize()
    counts = read_counts()
    # f32 weights: kernels B and E's sweep run per step, one launch for
    # each of T
    want = {**TRAIN_STEP_LAUNCHES, "gru_scan_fwd": cfg.max_qlen,
            "gru_scan_bwd_persistent": cfg.max_qlen}
    e_loss = abs(float(m_gpu["loss"]) - float(m_cpu["loss"])) / abs(
        float(m_cpu["loss"]))
    gpu_params = dict(gpu.named_parameters())
    grad_errs, worst_u = [], (0.0, "")
    sq_diff = sq_norm = 0.0
    for name, p in cpu.named_parameters():
        q = gpu_params[name]
        grad_errs.append((norm_err(q.grad.cpu(), p.grad), name))
        sq_diff += float((q.grad.cpu().double() - p.grad.double()).square().sum())
        sq_norm += float(p.grad.double().square().sum())
        # Adam's first update is lr * g / (|g| + eps): compared where |g|
        # is clear of 0 both against the tensor's scale and against eps
        # (1e-8), which magnifies a rounding-level change of a tiny g
        clear = ((p.grad.abs() > 1e-3 * float(p.grad.abs().max()))
                 & (p.grad.abs() > 100 * ADAM_EPS))
        du = ((q.detach().cpu() - p0[name]) - (p.detach() - p0[name]))
        eu = float(du[clear].abs().max()) / tcfg.lr if clear.any() else 0.0
        worst_u = max(worst_u, (eu, name))
    grad_errs.sort(reverse=True)
    e_all = math.sqrt(sq_diff / sq_norm)
    # The two devices round differently, so a unit whose forward value
    # lies within rounding of a relu boundary (or a max-pool tie) can
    # pass its gradient on one and not on the other: that moves a small
    # tensor's gradient by up to ~1e-2 of its scale (one conv1 relu flip
    # in 589824 units gave 6.4e-3 on a Gaussian kernel's projection)
    # while all gradients together stay within 1e-5. The kernels
    # themselves are held to their plain versions in phase 7.
    print(f"one f32 train step B={b}, card vs CPU: loss {float(m_gpu['loss']):.6f} "
          f"vs {float(m_cpu['loss']):.6f} (rel err {e_loss:.2e} <= 1e-5); "
          f"all gradients together rel L2 err {e_all:.2e} (<= 1e-5); worst "
          f"per-tensor normalized err (<= 1e-2): "
          + ", ".join(f"{n} {e:.2e}" for e, n in grad_errs[:3])
          + f"; worst Adam update err {worst_u[0]:.2e} x lr ({worst_u[1]}; "
          f"<= 1e-3); launches {counts}", flush=True)
    require(counts == want, f"launches per train step {counts}, want {want}")
    require(e_loss <= 1e-5, "train-step loss disagrees")
    require(e_all <= 1e-5 and grad_errs[0][0] <= 1e-2, "gradients disagree")
    require(worst_u[0] <= 1e-3, "Adam updates disagree")


def train_dataset(n_steps=20):
    """Phases 9, 11 and 12's in-memory synthetic dataset at full VQA
    width: n_steps training batches of TRAIN_B, val and an unannotated
    test split."""
    return generate_synthetic_vqa(
        n_images=128, n_questions=math.ceil(n_steps * TRAIN_B / 0.75),
        n_obj=36, feat_dim=FULL["feat_dim"] - 4, q_vocab=FULL["vocab_size"] - 1,
        n_answers=FULL["out_dim"] - 1, n_classes=64,
        class_encoding="binary", emb_dim=FULL["emb_dim"],
        max_qlen=FULL["max_qlen"], seed=SEED, with_test=True)


def run_fit(dev, ds, cache, label, n_steps=20, val_batches=10,
            merged=False):
    """fit() at full VQA width, bf16, dropout 0.5, batch 64, for the
    n_steps batches of ds["train"], with one mini-validation at the end;
    cache None is host mode, merged the merged graph block. Checks the
    losses, the moved parameters and the checkpoint, and the launches per
    step (the mini-validation's forwards launch A twice, or H once with
    the merged block, B once, and with a cache the image gather once, per
    batch).
    Returns (model, per-step losses, launch counts, median step ms)."""
    mcfg = ModelConfig(**FULL, merged_block=merged)  # bf16, dropout 0.5
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = TrainConfig(lr=1e-4, epochs=1, batch_size=TRAIN_B,
                           log_interval=1, eval_interval=n_steps,
                           save_dir=tmp, seed=SEED)
        jsonl = os.path.join(tmp, "metrics.jsonl")
        reset_counts()
        t0 = time.perf_counter()
        model, _, acc = fit(tcfg, mcfg, ds["train"], ds["val"], device=dev,
                            jsonl_path=jsonl, cache=cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        with open(jsonl) as f:
            recs = [json.loads(line) for line in f]
        saved = os.path.exists(os.path.join(tmp, "model_1.ckpt"))
    losses = [r["loss"] for r in recs]
    require(len(recs) == n_steps and all(map(math.isfinite, losses)),
            f"losses {losses}")
    # every parameter whose gradient Adam can act on has moved. A
    # Gaussian kernel whose weights underflow on (nearly) every edge
    # gives its projection a gradient far below Adam's eps, whose step
    # then rounds away in f32, here as in the JAX model
    fresh = dict(build_model(mcfg, ds["train"], device=dev,
                             seed=SEED).named_parameters())
    still = {k: float(p.grad.abs().max()) if p.grad is not None else 0.0
             for k, p in model.named_parameters()
             if torch.equal(p, fresh[k])}
    stuck = {k: g for k, g in still.items() if g > 100 * ADAM_EPS}
    require(len(still) < len(fresh) and not stuck,
            f"parameters with a gradient that did not move: {stuck}")
    require(saved, "no checkpoint at the mini-validation")
    per_step = dict(counts)
    if merged:
        per_step["graph_block_fwd"] -= val_batches
    else:
        per_step["edge_aggregate_fwd"] -= 2 * val_batches
    per_step["gru_scan_fwd"] -= val_batches
    want = TRAIN_STEP_LAUNCHES
    if cache is not None:
        per_step["gather_image_rows"] -= val_batches
        want = MERGED_STEP_LAUNCHES if merged else CACHE_STEP_LAUNCHES
    per_step = {k: v / n_steps for k, v in per_step.items()}
    step_ms = [1e3 / r["steps_per_sec"] for r in recs[2:]]
    med = statistics.median(step_ms)
    print(f"training ({label}): {n_steps} steps of fit() at full width, "
          f"batch {TRAIN_B}, bf16, dropout {mcfg.dropout}, in {wall:.3f} s "
          f"with one mini-validation ({val_batches} batches); loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}, all finite; epoch "
          f"accuracy {acc:.2f}%; {len(fresh) - len(still)} of "
          f"{len(fresh)} parameter tensors moved (unmoved, with the last "
          f"step's max |gradient|: {still}); median step {med:.3f} ms "
          f"(host clock, steps 3-{n_steps}, each ending in a fetch), "
          f"{TRAIN_B * 1e3 / med:.1f} QA-pairs/s; launches {counts}, per "
          f"train step {per_step}", flush=True)
    require(per_step == want, f"launches per train step {per_step}, "
            f"want {want}")
    require(counts["edge_aggregate_fwd"] == (0 if merged
                                             else 2 * val_batches),
            "kernel A ran outside the mini-validation")
    return model, losses, counts, med


def train_cache_main_path(dev, ds, cache, host_losses):
    """Phase 11, the main path with the device cache: run_fit with the
    bf16 cache; step 1's loss must equal host mode's (phase 9) bit for
    bit, and every step's within 1e-3."""
    require(isinstance(cache, tuple) and cache[0].dtype == torch.bfloat16
            and cache[0].device.type == "cuda", "no bf16 cache on the card")
    model, losses, counts, med = run_fit(dev, ds, cache, "device cache")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, host_losses)]
    print("relative loss difference from host mode (phase 9), per step: "
          + json.dumps(rel), flush=True)
    require(losses[0] == host_losses[0],
            f"step 1's loss {losses[0]!r} differs from host mode's "
            f"{host_losses[0]!r}")
    require(max(rel) <= 1e-3, "a cache-mode step's loss differs from host "
            "mode's by more than 1e-3")
    return model, losses, counts, med


def profile(fn, label: str, n: int = 10) -> None:
    """Device time per call by kernel (torch.profiler, CUPTI) beside the
    wall time of the same calls: the device's busy share, and the device
    items (kernels, copies and fills) launched per call."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows, counts = [], {}
    for evt in prof.key_averages():
        # kernels and copies only: an aten op's device time repeats its
        # kernels', and so does a user range such as Optimizer.step's
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            rows.append((evt.self_device_time_total / n / 1e3, evt.key))
            counts[evt.key] = evt.count / n
    rows.sort(reverse=True)
    busy = sum(ms for ms, _ in rows)
    gru = [[round(ms, 5), key[:60]] for ms, key in rows if "gru_" in key]
    edge = [[round(ms, 5), key[:70]] for ms, key in rows
            if "edge_" in key or "gauss" in key]
    gather = [[round(ms, 5), counts[key], key[:70]] for ms, key in rows
              if "gather" in key or "CatArray" in key]
    print(f"profile of {label}: wall {wall_ms:.4f} ms per call (profiler "
          f"on), device busy {busy:.4f} ms ({100 * busy / wall_ms:.1f}%), "
          f"{sum(counts.values()):g} device items launched per call; top "
          f"device items (ms per call): "
          + json.dumps([[round(ms, 5), key[:80]] for ms, key in rows[:12]])
          + "; the GRU kernels: " + json.dumps(gru)
          + "; the aggregation kernels: " + json.dumps(edge)
          + "; the gathers and concatenations (ms, launches per call): "
          + json.dumps(gather), flush=True)


def measure(dev, gen, launches, errs, model):
    """Phase 6, serving: kernels A and B, their plain versions and the
    library call, on CUDA events, and the whole bf16 forward that holds
    them (timed right after serving, as in the first slice)."""
    entries, detail = [], []
    for b in (SERVE_B, 256):
        batch = [x.to(dev) for x in random_batch(b, model.cfg, gen)]

        def forward():
            with torch.inference_mode():
                model(*batch)

        forward_ms = time_ms(forward, samples=20, reps=5)
        if b == SERVE_B:
            profile(forward, f"the bf16 forward at B={SERVE_B}")
        a_in = [edge_inputs(b, 36, 16, 8, d, use_alpha, gen, dev)
                for d, use_alpha in ((256, True), (128, False))]
        for x in a_in:
            x[2] = x[2].to(torch.bfloat16)

        def kernel_a():
            for sel, pseudo, proj, gp in a_in:
                fused_sel_aggregate_act(sel, pseudo, proj, gp, relu=True)

        def plain_a():
            for sel, pseudo, proj, gp in a_in:
                sel_aggregate_act_reference(sel, pseudo, proj, gp, relu=True)

        nbytes = sum(edge_bound(*x)[0] for x in a_in)
        ops_s = sum(edge_bound(*x)[1] for x in a_in)
        a = timed(kernel_a, plain_a, nbytes, ops_s)
        a["bmm_ms"] = edge_bmm_ms(a_in)
        per_conv = [time_device_ms(lambda x=x: fused_sel_aggregate_act(
            *x, relu=True)) for x in a_in]

        detail.append({"batch": b, "forward_ms": forward_ms,
                       "edge_aggregate_fwd": a,
                       "edge_aggregate_fwd_per_conv_ms": per_conv})
        if b == SERVE_B:
            entries.append(entry("edge_aggregate_fwd", a, launches, errs))
    g = time_gru_scan(dev, gen)
    entries.append(entry("gru_scan_fwd", g[SERVE_B], launches, errs))
    print("timing detail (bf16 forward, CUDA events back to back; kernels: "
          "device times, launches queued behind a sleep kernel, and "
          "back_to_back_ms with the host's enqueue in them; bf16 proj; A = "
          "conv1 + conv2 launches, the rule's body (mma); bmm_ms = one "
          "torch.bmm of the "
          "weights by the per-kernel slabs, a diagnostic of the product "
          "alone): " + json.dumps(detail), flush=True)
    print("kernel B timing (bf16 W_hh, T=16, H=1024; ms = the persistent "
          "kernel, one launch; per_step_ms = the per-step kernel of the "
          "first slice through its C entry gru_scan_fwd on the same bf16 "
          "weights, 16 launches; f32_weights_ms = the per-step kernel with "
          "f32 weights; library = cuDNN nn.GRU on a packed bf16 batch, "
          "input projection included): "
          + json.dumps({f"B={b}": t for b, t in g.items()}), flush=True)
    return entries


def slab_per_kernel(x, n):
    """(B, K, n*d) -> (B*n, K, d): each (image, Gaussian kernel) slab."""
    b, k, nd = x.shape
    return (x.reshape(b, k, n, nd // n).permute(0, 2, 1, 3)
            .reshape(b * n, k, nd // n).contiguous())


def edge_bmm_ms(a_in):
    """A diagnostic of what kernel A's product alone costs: one torch.bmm
    of the (B*n, K, K) weights by the (B*n, K, d) slabs per convolution
    (no Gaussians, no epilogue: not a yardstick of the whole
    function)."""
    bmm_in = []
    for sel, pseudo, proj, gp in a_in:
        n = gp.shape[1]
        ghat = sel_aggregate_act_residuals_reference(sel, pseudo, proj,
                                                     gp)[1]
        w = (sel[:, None] * ghat).flatten(0, 1).to(torch.bfloat16)
        bmm_in.append((w, slab_per_kernel(proj, n)))
    return time_device_ms(lambda: [torch.bmm(w, p) for w, p in bmm_in])


def time_gru_scan(dev, gen):
    """Phase 6, kernel B at B = 16, 64 and 256: the persistent kernel
    (bf16 W_hh) beside its plain version, its bound, cuDNN nn.GRU and the
    per-step kernel it replaced (the first slice's gru_scan_fwd entry,
    same bf16 weights), and the per-step kernel with f32 weights."""
    lib = _build.load("gru_scan")
    out = {}
    for b in (SERVE_B, TRAIN_B, 256):
        (xp, w_hh, b_hh, qlen), (emb, w_ih, b_ih) = gru_inputs(
            b, 16, 300, 1024, gen, dev)
        w16 = w_hh.to(torch.bfloat16)
        require(scan_kernel(w16.dtype, b, 1024) == "persistent",
                "kernel B's rule")
        gru = torch.nn.GRU(300, 1024, batch_first=True, device=dev,
                           dtype=torch.bfloat16)
        with torch.no_grad():
            gru.weight_ih_l0.copy_(w_ih)
            gru.weight_hh_l0.copy_(w_hh)
            gru.bias_ih_l0.copy_(b_ih)
            gru.bias_hh_l0.copy_(b_hh)
        gru.flatten_parameters()
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            emb.to(torch.bfloat16), qlen.cpu().long(), batch_first=True,
            enforce_sorted=False)

        def library_b():
            with torch.no_grad():
                gru(packed)

        h_a = torch.zeros((b, 1024), device=dev)
        h_b = torch.empty_like(h_a)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def per_step():
            return lib.gru_scan_fwd(
                xp.data_ptr(), w16.data_ptr(), b_hh.data_ptr(),
                qlen.data_ptr(), h_a.data_ptr(), h_b.data_ptr(), None, 16,
                b, 1024, 1, stream)

        _build.check(per_step(), "gru_scan_fwd")
        t = timed(lambda: gru_scan(xp, w16, b_hh, qlen),
                  lambda: gru_scan_reference(xp, w16, b_hh, qlen),
                  *gru_bound(xp, w16, b_hh, qlen), library=library_b)
        t["per_step_ms"] = time_device_ms(per_step)
        t["f32_weights_ms"] = time_device_ms(
            lambda: gru_scan(xp, w_hh, b_hh, qlen))
        out[b] = t
    return out


def entry(name, t, launches, errs):
    src, rep = SOURCES[name]
    return {"name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]}


def int_mul_per_s() -> float:
    """32-bit integer multiplies the card can issue per second: 64 per
    clock per SM (Hopper's IMAD rate, half its f32 FMA rate) at the SM's
    top clock as nvidia-smi reports it."""
    if not hasattr(int_mul_per_s, "rate"):
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60).stdout.split()[0])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        int_mul_per_s.rate = 64 * sms * mhz * 1e6
    return int_mul_per_s.rate


# 32-bit multiplies of one Philox4x32-10 word (csrc/edge_aggregate.cu::
# philox_bits) as ptxas compiles it for sm_90a (cuobjdump -sass of the
# SIMT training body): 12 IMAD.WIDE.U32 (a 64-bit product: two) and 4
# 32-bit IMAD / IMAD.HI per word; round 0's products of the zero counter
# word fold away, and the last rounds' products that word 0 does not
# read are dropped
PHILOX_MULS = 28


def residual_bound(sel, pseudo, proj, gparams, rate):
    """Kernel C: kernel A's bytes and operations, plus the residuals
    written and the seeds read, and with dropout one Philox word per
    output element: PHILOX_MULS 32-bit multiplies at the integer
    multiply rate. Returns (bytes, seconds of operations, the four
    least times in ms: bytes, bf16 product, f32 Gaussians, Philox)."""
    nbytes, _ = edge_bound(sel, pseudo, proj, gparams)
    b, k, nd = proj.shape
    n = gparams.shape[1]
    nbytes += (n + 1) * b * k * k * 4 + (b * 4 if rate else 0)
    terms = {"bytes": nbytes / PEAK_BYTES,
             "product": 2 * b * k * k * nd / PEAK_FLOPS[proj.dtype],
             "gaussians": GAUSS_FLOPS * b * k * k * n
             / PEAK_FLOPS[torch.float32],
             "philox": (PHILOX_MULS * proj.numel() / int_mul_per_s()
                        if rate else 0.0)}
    ops_s = terms["product"] + terms["gaussians"] + terms["philox"]
    return nbytes, ops_s, {t: v * 1e3 for t, v in terms.items()}


def vjp_bound(sel, pseudo, proj, gparams, epilogue):
    """Kernel D: g, proj (and out) in, dproj out, in proj's dtype; sel,
    ghat, denom, pseudo in and dsel, dpseudo out in f32; two K x K x n*d
    products and ~40 flops per edge and Gaussian kernel."""
    b, k, nd = proj.shape
    n = gparams.shape[1]
    slabs = 4 if epilogue else 3
    nbytes = (slabs * proj.numel() * proj.element_size()
              + b * k * k * 4 * (1 + n + 1 + 2 + 1 + 2)
              + 2 * gparams.numel() * 4)
    ops_s = (2 * 2 * b * k * k * nd / PEAK_FLOPS[proj.dtype]
             + 40 * b * k * k * n / PEAK_FLOPS[torch.float32])
    return nbytes, ops_s


def sweep_bound(xp, w_hh, qlen):
    """Kernel E's reverse sweep: xp, hs, W once and dxp (f32), dhp (W's
    dtype) out; per step and active row the hp recompute, and for rows
    active one step later the product dhp @ W, ~30 flops per unit."""
    t, b, h3 = xp.shape
    h = h3 // 3
    q = qlen.clamp(max=t).long()
    nbytes = (xp.numel() * 4 * 2 + w_hh.numel() * w_hh.element_size()
              + t * b * h * 4 + b * h * 4 + h3 * 4 + b * 4
              + xp.numel() * w_hh.element_size())
    rows = int(q.sum()) + int((q - 1).clamp(min=0).sum())
    ops_s = (2 * h * h3 * rows / PEAK_FLOPS[w_hh.dtype]
             + 30 * h * int(q.sum()) / PEAK_FLOPS[torch.float32])
    return nbytes, ops_s


def wgrad_bound(dhp, hs, qlen):
    """Kernel E's dW/db: dhp and the states hs (hs16 for the wgmma
    product) in, dW and db out (f32); products only where dhp and h_prev
    are both non-zero (steps 1 .. qlen-1)."""
    t, b, h3 = dhp.shape
    h = h3 // 3
    nbytes = (dhp.numel() * dhp.element_size() + hs.numel() * hs.element_size()
              + h3 * h * 4 + h3 * 4)
    rows = int((qlen.clamp(max=t).long() - 1).clamp(min=0).sum())
    return nbytes, 2 * h3 * h * rows / PEAK_FLOPS[dhp.dtype]


def timed(kernel, plain, nbytes, ops_s, library=None):
    """Device times (time_device_ms) of the kernel, its plain version and
    the library call beside the bound, and the kernel's back-to-back
    event time, which holds the host's enqueue where a call is shorter
    on the card than on the host. The plain version, hundreds of small
    launches, is taken one call a sample."""
    t = dict(ms=time_device_ms(kernel),
             plain_ms=time_device_ms(plain, samples=10, reps=1),
             library_ms=(time_device_ms(library) if library else None),
             back_to_back_ms=time_ms(kernel))
    t["bound_ms"], t["bound_by"] = bound(nbytes, ops_s)
    return t


def measure_training(dev, gen, counts, errs):
    """Phase 6, training: kernels C, D and E at the training shapes (B=64
    main path, and B=256), each against its plain version, its bound and
    the library call where one exists; the whole training step at B=64
    and 256, and a profile of it at B=64."""
    entries, detail = [], []
    for b in (TRAIN_B, 256):
        convs = []
        for d, use_alpha in ((256, True), (128, False)):
            sel, pseudo, proj, gp = edge_inputs(b, 36, 16, 8, d, use_alpha,
                                                gen, dev)
            rate = DROPOUT if use_alpha else 0.0
            seeds = random_seeds(b, gen, dev) if rate else None
            proj = proj.to(torch.bfloat16)
            out, ghat, denom = sel_aggregate_act_residuals(
                sel, pseudo, proj, gp, True, rate, seeds)
            g = torch.randn(proj.shape, generator=gen).to(dev, torch.bfloat16)
            convs.append((sel, pseudo, proj, gp, rate, seeds, out, ghat,
                          denom, g))

        def c_kernel():
            for sel, pseudo, proj, gp, rate, seeds, *_ in convs:
                sel_aggregate_act_residuals(sel, pseudo, proj, gp, True,
                                            rate, seeds)

        def c_plain():
            for sel, pseudo, proj, gp, rate, seeds, *_ in convs:
                sel_aggregate_act_residuals_reference(sel, pseudo, proj, gp,
                                                      True, rate, seeds)

        def d_kernel():
            for sel, pseudo, proj, gp, rate, _, out, ghat, denom, g in convs:
                sel_aggregate_act_vjp(g, sel, ghat, denom, pseudo, proj, gp,
                                      out, rate)

        def d_plain():
            for sel, pseudo, proj, gp, rate, _, out, ghat, denom, g in convs:
                sel_aggregate_act_vjp_reference(g, sel, ghat, denom, pseudo,
                                                proj, gp, out, rate)

        c_b = [residual_bound(*x[:5]) for x in convs]
        d_b = [vjp_bound(*x[:4], True) for x in convs]
        c = timed(c_kernel, c_plain, sum(x[0] for x in c_b),
                  sum(x[1] for x in c_b))
        c["bound_terms_ms"] = {
            term: sum(x[2][term] for x in c_b) for term in c_b[0][2]}
        d = timed(d_kernel, d_plain, sum(x[0] for x in d_b),
                  sum(x[1] for x in d_b))
        bmm_c, bmm_d = [], []
        for sel, pseudo, proj, gp, _, _, out, ghat, denom, g in convs:
            n = gp.shape[1]
            w = (sel[:, None] * ghat).flatten(0, 1).to(torch.bfloat16)
            p_s, g_s = slab_per_kernel(proj, n), slab_per_kernel(g, n)
            bmm_c.append((w, p_s))
            bmm_d.append((w.transpose(1, 2), g_s, p_s.transpose(1, 2)))
        c["bmm_ms"] = time_device_ms(
            lambda: [torch.bmm(w, p) for w, p in bmm_c])
        d["bmm_ms"] = time_device_ms(
            lambda: [(torch.bmm(wt, g), torch.bmm(g, pt))
                     for wt, g, pt in bmm_d])

        (xp, w_hh, b_hh, qlen), (emb, w_ih, b_ih) = gru_inputs(
            b, 16, 300, 1024, gen, dev)
        w16 = w_hh.to(torch.bfloat16)
        _, hs, hs16, hp = gru_scan(xp, w16, b_hh, qlen, return_hs=True,
                                   return_hp=True)
        hid = w_hh.shape[1]
        gh = torch.randn(b, hid, generator=gen).to(dev)
        _, dhp = gru_scan_bwd(xp, w16, b_hh, qlen, hs, gh, hp)
        gru = torch.nn.GRU(300, hid, batch_first=True, device=dev,
                           dtype=torch.bfloat16)
        with torch.no_grad():
            for name, x in (("weight_ih_l0", w_ih), ("weight_hh_l0", w_hh),
                            ("bias_ih_l0", b_ih), ("bias_hh_l0", b_hh)):
                getattr(gru, name).copy_(x)
        gru.flatten_parameters()
        gh16 = gh.to(torch.bfloat16)[None]
        # packed once, its data a leaf: packing copies the sort order to
        # the card from pageable memory, which waits on the device
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            emb.to(torch.bfloat16), qlen.cpu().long(), batch_first=True,
            enforce_sorted=False)
        packed = torch.nn.utils.rnn.PackedSequence(
            packed.data.requires_grad_(True), packed.batch_sizes,
            packed.sorted_indices, packed.unsorted_indices)

        def cudnn_fwd_bwd():
            _, h_n = gru(packed)
            h_n.backward(gh16)

        def cudnn_fwd():
            with torch.no_grad():
                gru(packed)

        e = timed(lambda: gru_scan_bwd(xp, w16, b_hh, qlen, hs, gh, hp),
                  lambda: gru_scan_sweep_reference(xp, w16, b_hh, qlen, hs,
                                                   gh, hp),
                  *sweep_bound(xp, w16, qlen), library=cudnn_fwd_bwd)
        e["plain_recompute_ms"] = time_device_ms(
            lambda: gru_scan_sweep_reference(xp, w16, b_hh, qlen, hs, gh),
            samples=10, reps=1)
        e["per_step_ms"] = time_sweep_per_step(xp, w16, b_hh, qlen, hs, gh)
        e["cudnn_fwd_ms"] = time_device_ms(cudnn_fwd)
        e["b_forward_ms"] = time_device_ms(
            lambda: gru_scan(xp, w16, b_hh, qlen, return_hs=True))
        e["b_forward_with_hp_ms"] = time_device_ms(
            lambda: gru_scan(xp, w16, b_hh, qlen, return_hs=True,
                             return_hp=True))
        h_prev = hs16[:-1].reshape(-1, hid)
        dhp_rows = dhp[1:].reshape(-1, 3 * hid)
        wg = timed(lambda: gru_wgrad(dhp, hs16),
                   lambda: gru_wgrad_reference(dhp, hs16),
                   *wgrad_bound(dhp, hs16, qlen),
                   library=lambda: torch.mm(dhp_rows.t(), h_prev,
                                            out_dtype=torch.float32))
        wg["simt_ms"] = time_wgrad_simt(dhp, hs)
        step_ms = time_train_step(dev, gen, b)
        detail.append({"batch": b, "train_step_ms": step_ms,
                       "train_qa_pairs_per_s": b * 1e3 / step_ms,
                       "edge_aggregate_fwd_res": c, "edge_aggregate_bwd": d,
                       "gru_scan_bwd_persistent": e, "gru_wgrad": wg})
        if b == TRAIN_B:
            for name, t in (("edge_aggregate_fwd_res", c),
                            ("edge_aggregate_bwd", d),
                            ("gru_scan_bwd_persistent", e),
                            ("gru_wgrad", wg)):
                entries.append(entry(name, t, counts, errs))
    print("training timing detail (bf16; kernels: device times, launches "
          "queued behind a sleep kernel, and back_to_back_ms; C and D = "
          "conv1 with dropout + conv2, the rule's body (mma), bmm_ms = "
          "torch.bmm of the same "
          "per-(image, kernel) products (C one, D two; a diagnostic of the "
          "products alone), C's bound_terms_ms = bytes at 3.35 TB/s, bf16 "
          "product at 989 TFLOP/s, Gaussians at 67 TFLOP/s, Philox "
          f"multiplies at {int_mul_per_s():.4g}/s; E sweep = the persistent "
          "sweep, one launch, plain = its plain version fed the same hp, "
          "plain_recompute_ms = the plain version recomputing hp, "
          "per_step_ms = the per-step sweep of the second slice through "
          "its C entry gru_scan_bwd_step (16 launches) on the same bf16 "
          "weights, library = cuDNN nn.GRU forward + backward together, "
          "cudnn_fwd_ms = its forward alone, b_forward_ms / "
          "b_forward_with_hp_ms = kernel B's training forward without / "
          "with hp; E dW/db = the wgmma product from hs16, library = one "
          "cuBLAS mm for dW alone, simt_ms = the SIMT reduction of the "
          "second slice through its C entry gru_wgrad (f32 hs); "
          "train step = host clock per step ending in a fetch, median of "
          "10): " + json.dumps(detail), flush=True)
    return entries


def time_sweep_per_step(xp, w16, b_hh, qlen, hs, gh):
    """Phase 6: device ms of the per-step sweep that the persistent one
    replaced (gru_scan_bwd.cu::gru_scan_bwd_step, T launches), on the
    same bf16 inputs, through its C entry."""
    t, b, h3 = xp.shape
    h = h3 // 3
    lib = _build.load("gru_scan_bwd")
    w_t = w16.t().contiguous()
    dxp = torch.empty_like(xp)
    dhp = torch.empty(xp.shape, dtype=w16.dtype, device=xp.device)
    bufs = (torch.empty_like(gh), torch.empty_like(gh))
    stream = torch.cuda.current_stream(xp.device).cuda_stream

    def call():
        c_in = gh
        for i, step in enumerate(reversed(range(t))):
            _build.check(lib.gru_scan_bwd_step(
                xp[step].data_ptr(), w16.data_ptr(), w_t.data_ptr(),
                b_hh.data_ptr(), qlen.data_ptr(),
                hs[step - 1].data_ptr() if step else None,
                dhp[step + 1].data_ptr() if step < t - 1 else None,
                c_in.data_ptr(), dxp[step].data_ptr(), dhp[step].data_ptr(),
                bufs[i % 2].data_ptr(), b, h, step, 1, stream),
                "gru_scan_bwd_step")
            c_in = bufs[i % 2]

    return time_device_ms(call)


def time_wgrad_simt(dhp, hs):
    """Phase 6: device ms of the SIMT weight-gradient reduction that the
    wgmma product replaced (gru_scan_bwd.cu::gru_wgrad, f32 states), on
    the same bf16 dhp, through its C entry."""
    t, b, h3 = dhp.shape
    h = h3 // 3
    require(wgrad_kernel(dhp.dtype, h) == "wgmma", "kernel E's dW/db rule")
    dw = torch.empty((h3, h), device=dhp.device)
    db = torch.empty((h3,), device=dhp.device)
    stream = torch.cuda.current_stream(dhp.device).cuda_stream
    simt = _build.load("gru_scan_bwd").gru_wgrad

    def call():
        return simt(dhp.data_ptr(), hs.data_ptr(), dw.data_ptr(),
                    db.data_ptr(), t, b, h, 1, stream)

    _build.check(call(), "gru_wgrad")
    return time_device_ms(call)


def time_train_step(dev, gen, b, n=10):
    """Median host-clock ms of a full-width bf16 training step (dropout
    0.5), each step ending in a fetch of its loss; profiled at B=64."""
    cfg = ModelConfig(**FULL)
    model = GraphVQAModel(cfg, device=dev, seed=SEED)
    optimizer, _ = make_optimizer(model, TrainConfig(), 100)
    generator = torch.Generator(device=dev).manual_seed(SEED)
    batch = random_train_batch(b, cfg, gen)

    def step():
        float(train_step(model, optimizer, None, batch, generator)["loss"])

    ms = median_step_ms(step, n)
    if b == TRAIN_B:
        profile(step, f"the bf16 training step at B={b}", n=5)
    return ms


# ---------------- the device cache: kernels F and G ----------------


def random_table(n, k, f, dtype, dev, seed=SEED):
    """An (n, k, f) table made on the card: normal values, or int8 codes
    in [-127, 127]; filled in chunks of 8192 rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    table = torch.empty((n, k, f), dtype=dtype, device=dev)
    for i in range(0, n, 8192):
        part = table[i:i + 8192]
        if dtype == torch.int8:
            part.copy_(torch.randint(-127, 128, part.shape, generator=g,
                                     device=dev, dtype=torch.int8))
        else:
            part.normal_(generator=g)
    return table


def gather_rows_for(b, n, rng):
    """(B,) int32 rows: row N-1 and 0 first, a duplicate, the clamped -1
    and N, the rest random."""
    rows = rng.integers(0, n, b)
    special = [n - 1, 0, -1, n]
    rows[:min(b, 4)] = special[:min(b, 4)]
    if b > 5:
        rows[-1] = rows[4]
    return rows.astype(np.int32)


GATHER_B = (1, 16, 33, 63, 64, 65, 256, 257)
# output sentinels: NaN in float outputs; -128 in an int8 copy, a code
# random_table never makes
SENTINEL = {torch.float32: float("nan"), torch.bfloat16: float("nan"),
            torch.int8: -128}


def check_gathers(dev):
    """Phase 10: F and G against their plain
    versions on the card, bit for bit, and F again into outputs filled
    with a sentinel first. Returns {kernel: max abs error}."""
    rng = np.random.default_rng(SEED)
    errs = {"gather_rows_packed": 0.0, "gather_rows_blocked": 0.0}

    def check(name, got, want, what):
        torch.cuda.synchronize()
        same = (got.dtype == want.dtype and got.shape == want.shape
                and torch.equal(got, want))
        err = float((got.float() - want.float()).abs().max())
        errs[name] = max(errs[name], err)
        print(f"{what}: equal bit for bit {same} (max abs err {err:.3e})",
              flush=True)
        require(same, f"{name} disagrees with its plain version: {what}")

    def check_f(label, table, scales, outs, sizes):
        n, k, f = table.shape
        gb = table.numel() * table.element_size() / 1e9
        for b in sizes:
            r = torch.from_numpy(gather_rows_for(b, n, rng)).to(dev)
            for out in outs:
                want = gather_rows_reference(table, r, scales, out)
                what = (f"kernel F {label} table {n} x {k} x {f} ({gb:.1f} "
                        f"GB)" + (f" -> {str(out)[6:]}" if out else "")
                        + f", B={b}")
                check("gather_rows_packed",
                      gather_rows_packed(table, r, scales, out), want, what)
                if b in (1, 65, 257):
                    filled = torch.full_like(want, SENTINEL[want.dtype])
                    check("gather_rows_packed", gather_rows_packed(
                        table, r, scales, out, out=filled), want,
                        f"{what}, into {SENTINEL[want.dtype]}-filled out")

    k, f = 36, 2048
    for label, n, dtype, scales_out in (
            ("bf16", VQA_IMAGES, torch.bfloat16, None),
            ("int8", VQA_IMAGES, torch.int8, (torch.bfloat16, torch.float32)),
            ("f32", 4096, torch.float32, None)):
        table = random_table(n, k, f, dtype, dev)
        scales = None
        if scales_out:
            g = torch.Generator(device=dev).manual_seed(SEED + 1)
            scales = torch.rand((n, k), generator=g, device=dev) * 0.05
        check_f(label, table, scales, scales_out or (None,), GATHER_B)
        if label == "bf16":   # the last row of the 18 GB table, read back
            last = gather_rows_packed(table, torch.tensor(
                [n - 1, n], dtype=torch.int32, device=dev))
            check("gather_rows_packed", last[0], table[n - 1],
                  "kernel F bf16 rows N-1 and N against table[N-1]")
            check("gather_rows_packed", last[1], table[n - 1],
                  "kernel F bf16 row N (clamped) against table[N-1]")
        del table, scales
        torch.cuda.empty_cache()
    # rows of 21 and 15 16-byte vectors, each less than one block's chunk
    # of 1024; the int8 table copied as it is; the int8 path's
    # element-wise variant (F not a multiple of 16)
    small = (1, 63, 65, 257)
    check_f("bf16 rows of 21 vectors", random_table(4099, 7, 24,
                                                    torch.bfloat16, dev),
            None, (None,), small)
    q = random_table(1000, 5, 48, torch.int8, dev)
    check_f("int8 rows of 15 vectors", q, torch.rand((1000, 5), device=dev),
            (torch.bfloat16, torch.float32), small)
    check_f("int8 copy", q, None, (None,), small)
    check_f("int8 F=20", random_table(1000, 5, 20, torch.int8, dev),
            torch.rand((1000, 5), device=dev), (torch.bfloat16,),
            (1, 33, 63, 65, 256, 257))
    for label, shape, dtype in (
            ("boxes", (VQA_IMAGES, 36, 4), torch.float32),
            ("odd f32", (1000, 5, 3), torch.float32),
            ("odd bf16", (1000, 7, 3), torch.bfloat16)):
        table = random_table(*shape, dtype, dev)
        for b in (1, 16, 33, 64, 256):
            r = torch.from_numpy(gather_rows_for(b, shape[0], rng)).to(dev)
            check("gather_rows_blocked", gather_rows_blocked(table, r),
                  gather_rows_reference(table, r),
                  f"kernel G {label} table {shape}, B={b}")
    return errs


# phase 10's image gathers: (label, N, K, F, table dtype, node dtypes).
# The VQA v2-size tables (64-bit offsets), K = 51 (the medical preset:
# odd boxes in every image), and shapes that take the element-wise
# variant (F = 20 bf16, F = 24 int8, F = 6 f32) or the vector body with
# 8-byte stores inside a box (F = 24 bf16: boxes of 3 vectors)
IMAGE_TABLES = (
    ("bf16", VQA_IMAGES, 36, 2048, torch.bfloat16,
     (torch.bfloat16, torch.float32)),
    ("int8", VQA_IMAGES, 36, 2048, torch.int8,
     (torch.bfloat16, torch.float32)),
    ("f32", 4096, 36, 2048, torch.float32, (torch.float32, torch.bfloat16)),
    ("bf16 K=51", 4096, 51, 2048, torch.bfloat16,
     (torch.bfloat16, torch.float32)),
    ("int8 K=51", 4096, 51, 2048, torch.int8,
     (torch.bfloat16, torch.float32)),
    ("f32 K=51", 4096, 51, 2048, torch.float32,
     (torch.float32, torch.bfloat16)),
    ("bf16 F=24", 1000, 7, 24, torch.bfloat16,
     (torch.bfloat16, torch.float32)),
    ("bf16 F=20", 1000, 5, 20, torch.bfloat16,
     (torch.bfloat16, torch.float32)),
    ("int8 F=24", 1000, 7, 24, torch.int8, (torch.bfloat16, torch.float32)),
    ("f32 F=6", 1000, 3, 6, torch.float32, (torch.float32, torch.bfloat16)),
)


def check_image_gathers(dev):
    """Phase 10, the image gather (kernel G's redesign): gather_image_rows
    against gather_image_reference, bit for bit, for every IMAGE_TABLES
    entry, node dtype and layout (contiguous F + 4 and padded rows) at
    every GATHER_B (F <= 24: B in {1, 63, 65, 257}), into NaN-filled
    buffers whose pad columns must come back exactly 0, and once into
    fresh buffers. Returns the max abs error."""
    rng = np.random.default_rng(SEED + 6)
    worst = 0.0
    for label, n, k, f, dtype, node_dtypes in IMAGE_TABLES:
        table = random_table(n, k, f, dtype, dev)
        boxes = random_table(n, k, 4, torch.float32, dev, seed=SEED + 7)
        scales = (torch.rand((n, k), device=dev) * 0.05
                  if dtype == torch.int8 else None)
        sizes = GATHER_B if f > 24 else (1, 63, 65, 257)
        for nd in node_dtypes:
            for padded in (False, True):
                ld = node_row_stride(f + 4, padded)
                for b in sizes:
                    r = torch.from_numpy(gather_rows_for(b, n, rng)).to(dev)
                    want = gather_image_reference(table, boxes, r, scales,
                                                  nd, padded)
                    buf = torch.full((b, k, ld), float("nan"), dtype=nd,
                                     device=dev)
                    bx = torch.full((b, k, 4), float("nan"), device=dev)
                    got = gather_image_rows(table, boxes, r, scales, nd,
                                            padded, out=(buf, bx))
                    fresh = (gather_image_rows(table, boxes, r, scales, nd,
                                               padded) if b == 65 else got)
                    torch.cuda.synchronize()
                    for g in (got, fresh):
                        same = (torch.equal(g.nodes, want.nodes)
                                and torch.equal(g.boxes, want.boxes))
                        worst = max(worst, float(
                            (g.nodes.float() - want.nodes.float()).abs()
                            .max()), float((g.boxes - want.boxes).abs().max()))
                        require(same, f"gather_image_rows {label} -> {nd} "
                                f"padded={padded} B={b} disagrees with "
                                f"its plain version")
                    pad = buf[..., f + 4:]
                    require(int(torch.count_nonzero(pad)) == 0
                            and not bool(buf.isnan().any()),
                            f"gather_image_rows {label} -> {nd} padded="
                            f"{padded} B={b}: pad columns not 0, or a NaN "
                            f"left in the buffer")
                print(f"image gather {label} table {n} x {k} x {f} -> "
                      f"{str(nd)[6:]} nodes, row stride {ld}: equal bit for "
                      f"bit to gather_image_reference at B = {list(sizes)} "
                      f"(into NaN-filled buffers, pad columns 0; B=65 also "
                      f"into fresh ones)", flush=True)
        del table, boxes, scales
        torch.cuda.empty_cache()
    return worst


def evaluate_checks(dev, model, ds, cache):
    """Phase 12: evaluate() with phase 11's model. Returns the int8
    cache's agreement with the bf16 cache."""
    val = ds["val"]
    words = set(val.a_itow.values())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "result.json")
        f0 = gather_image_rows.launches
        acc_r, res_r, adj = evaluate(model, val, TRAIN_B, result_path=path,
                                     cache=cache, device=dev)
        with open(path) as f:
            loaded = json.load(f)
        f_launches = gather_image_rows.launches - f0
        acc_s, res_s, _ = evaluate(model, val, TRAIN_B, result_path=None,
                                   cache=None, device=dev)
        print(f"evaluate val ({val.n_questions} questions): resident "
              f"(device cache, the image gather launched {f_launches} "
              f"times) accuracy "
              f"{acc_r:.4f}%, streaming (host mode) {acc_s:.4f}%; result "
              f"lists equal {res_r == res_s}; {len(res_r)} entries, "
              f"{len({r['answer'] for r in res_r})} distinct answers; "
              f"result.json parses to the same list {loaded == res_r}",
              flush=True)
        require(adj is None and f_launches == math.ceil(
            val.n_questions / TRAIN_B), "the resident path did not gather "
            "every batch in one launch of gather_image_rows")
        require(res_r == res_s, "resident and streaming results differ")
        require(abs(acc_r - acc_s) <= 1e-4, "accuracies differ")
        require(len(res_r) == val.n_questions and loaded == res_r,
                "result.json entries")
        require(all(r["answer"] in words for r in res_r),
                "an answer outside a_itow")
        test = ds["test"]
        acc_t, res_t, _ = evaluate(model, test, TRAIN_B,
                                   result_path=path, device=dev)
        with open(path) as f:
            loaded = json.load(f)
    print(f"evaluate test ({test.n_questions} unannotated questions, its "
          f"own {test.store.features.shape[0]}-image cache): accuracy "
          f"{acc_t}, {len(res_t)} entries", flush=True)
    require(acc_t == 0.0 and len(res_t) == test.n_questions
            and loaded == res_t, "test split")
    _, res_a, adj = evaluate(model, val, TRAIN_B, result_path=None,
                             collect_adjacency=True, max_batches=2,
                             cache=cache, device=dev)
    shapes = {a.shape for a in adj.values()}
    print(f"collect_adjacency over 2 batches: {len(adj)} adjacencies of "
          f"shapes {shapes}, {len(res_a)} answers", flush=True)
    require(len(adj) == len(res_a) == min(2 * TRAIN_B, val.n_questions)
            and shapes == {(36, 36)}, "adjacencies")
    qc = make_feature_cache(val, TrainConfig(feature_cache_dtype="int8"),
                            model.cfg.compute_dtype, dev)
    require(isinstance(qc, QuantizedFeatureCache)
            and qc.features.dtype == torch.int8, "no int8 cache")
    f0 = gather_image_rows.launches
    acc_q, res_q, _ = evaluate(model, val, TRAIN_B, result_path=None,
                               cache=qc, device=dev)
    f_launches = gather_image_rows.launches - f0
    agree = float(np.mean([a == b for a, b in zip(res_q, res_r)]))
    print(f"evaluate val with the int8 cache: the image gather launched "
          f"{f_launches} "
          f"times on the int8 table; accuracy {acc_q:.4f}%; answers equal "
          f"to the bf16 cache's: {agree:.4f}", flush=True)
    require(f_launches == math.ceil(val.n_questions / TRAIN_B)
            and len(res_q) == val.n_questions, "int8 evaluate")
    return agree


def timed_gather(kernel, plain, library):
    """Device times (time_device_ms: a gather is shorter than its
    wrapper's host time), and the kernel's back-to-back time with the
    host's enqueue in it (time_ms)."""
    return dict(ms=time_device_ms(kernel), plain_ms=time_device_ms(plain),
                library_ms=library and time_device_ms(library),
                back_to_back_ms=time_ms(kernel))


def gather_spread(fns, rounds=6):
    """The named calls of `fns` (F beside torch.index_select), each
    timed `rounds` times in turns, the order reversed every other round,
    every time the median of time_device_ms' 50 samples: the medians'
    lists, to read F's verdict against the spread of the readings."""
    out = {name: [] for name in fns}
    order = list(fns.items())
    for r in range(rounds):
        for name, fn in (order if r % 2 == 0 else order[::-1]):
            out[name].append(time_device_ms(fn))
    return out


def time_gathers(dev, counts, errs):
    """Phase 6, the cache part, kernels: F on the VQA v2-size bf16 table
    (and at N=4096, and int8 -> bf16), G on its boxes, at B=64 and 256;
    each call takes the next of 16 random row sets, so the rows come from
    all over the table."""
    rng = np.random.default_rng(SEED + 2)
    entries, detail = [], {}
    k, f = 36, 2048
    for label, n, dtype in (("bf16", VQA_IMAGES, torch.bfloat16),
                            ("bf16 N=4096", 4096, torch.bfloat16),
                            ("int8 -> bf16", VQA_IMAGES, torch.int8)):
        table = random_table(n, k, f, dtype, dev)
        scales = (torch.rand((n, k), device=dev) * 0.05
                  if dtype == torch.int8 else None)
        out = torch.bfloat16 if scales is not None else None
        for b in (TRAIN_B, 256):
            sets = [torch.from_numpy(rng.integers(0, n, b).astype(np.int32)
                                     ).to(dev) for _ in range(16)]
            it = iter(range(10 ** 9))

            def rows():
                return sets[next(it) % len(sets)]

            t = timed_gather(
                lambda: gather_rows_packed(table, rows(), scales, out),
                lambda: gather_rows_reference(table, rows(), scales, out),
                None if scales is not None else
                (lambda: torch.index_select(table, 0, rows())))
            row_bytes = k * f * table.element_size()
            out_bytes = k * f * 2 if scales is not None else row_bytes
            t["bound_ms"], t["bound_by"] = bound(
                b * (row_bytes + out_bytes) + b * 4
                + (b * k * 4 if scales is not None else 0), 0.0)
            detail[f"F {label} B={b}"] = t
            if label == "bf16":
                t["spread"] = gather_spread({
                    "F_ms": lambda: gather_rows_packed(table, rows()),
                    "index_select_ms": lambda: torch.index_select(
                        table, 0, rows())})
            if label == "bf16" and b == TRAIN_B:
                entries.append(entry("gather_rows_packed", t, counts, errs))
        del table, scales
        torch.cuda.empty_cache()
    boxes = random_table(VQA_IMAGES, 36, 4, torch.float32, dev)
    for b in (TRAIN_B, 256):
        sets = [torch.from_numpy(rng.integers(0, VQA_IMAGES, b).astype(
            np.int32)).to(dev) for _ in range(16)]
        it = iter(range(10 ** 9))

        def rows():
            return sets[next(it) % len(sets)]

        t = timed_gather(lambda: gather_rows_blocked(boxes, rows()),
                         lambda: gather_rows_reference(boxes, rows()),
                         lambda: torch.index_select(boxes, 0, rows()))
        t["bound_ms"], t["bound_by"] = bound(2 * b * 36 * 4 * 4 + b * 4, 0.0)
        detail[f"G boxes B={b}"] = t
        if b == TRAIN_B:
            entries.append(entry("gather_rows_blocked", t, counts, errs))
    del boxes
    torch.cuda.empty_cache()
    print("gather timing detail (CUDA events, launches queued behind a "
          "sleep kernel; back_to_back_ms = the kernel's calls timed back to "
          "back with the host's enqueue in them; F plain = clamp + "
          "index_select (+ dequant), library = one torch.index_select; "
          "spread = F and index_select timed 6 times each in "
          "turns, each a median of 50 "
          "samples; bound = rows read + written at 3.35 TB/s): "
          + json.dumps(detail), flush=True)
    return entries


def image_bytes(b, k, f, ld, table_dtype, node_dtype):
    """Bytes the image gather must move: each table row, box row, row
    index and (int8) scale read once, the node rows (pad included) and
    the f32 boxes written once."""
    el = torch.empty((), dtype=table_dtype).element_size()
    out = torch.empty((), dtype=node_dtype).element_size()
    return (b * k * f * el + b * k * 16 + b * 4
            + (b * k * 4 if table_dtype == torch.int8 else 0)
            + b * k * ld * out + b * k * 16)


def time_image_gathers(dev, counts, errs):
    """Phase 6, the cache part: the image gather (one launch writing the
    node rows and boxes) on the VQA v2-size table in bf16 and int8 ->
    bf16, at B=64 and 256, contiguous and padded rows, beside (a) the
    assembly it replaces (F + G + the boxes' cast + torch.cat, or F + G +
    padded_rows), (b) F alone on the same rows, (c) the library sequence
    (two index_selects, the boxes' cast and a torch.cat; F.pad after it
    for padded rows; bf16 only) and (d) its byte bound; in bf16 all four
    timed six times each in turns (gather_spread)."""
    rng = np.random.default_rng(SEED + 5)
    entries, detail = [], {}
    k, f, nd = 36, 2048, torch.bfloat16
    boxes = random_table(VQA_IMAGES, k, 4, torch.float32, dev)
    for label, dtype in (("bf16", torch.bfloat16), ("int8 -> bf16",
                                                    torch.int8)):
        table = random_table(VQA_IMAGES, k, f, dtype, dev)
        scales = (torch.rand((VQA_IMAGES, k), device=dev) * 0.05
                  if dtype == torch.int8 else None)
        f_out = nd if scales is not None else None
        for b in (TRAIN_B, 256):
            sets = [torch.from_numpy(rng.integers(0, VQA_IMAGES, b).astype(
                np.int32)).to(dev) for _ in range(16)]
            it = iter(range(10 ** 9))

            def rows():
                return sets[next(it) % len(sets)]

            for padded in (False, True):
                ld = node_row_stride(f + 4, padded)

                def fused():
                    gather_image_rows(table, boxes, rows(), scales, nd,
                                      padded)

                def plain():
                    gather_image_reference(table, boxes, rows(), scales, nd,
                                           padded)

                def assembly():
                    r = rows()
                    parts = [gather_rows_packed(table, r, scales, f_out),
                             gather_rows_blocked(boxes, r)]
                    if padded:
                        padded_rows(parts, nd)
                    else:
                        torch.cat([parts[0], parts[1].to(nd)], dim=-1)

                def f_alone():
                    gather_rows_packed(table, rows(), scales, f_out)

                def library():
                    r = rows()
                    x = torch.cat([torch.index_select(table, 0, r),
                                   torch.index_select(boxes, 0, r).to(nd)],
                                  dim=-1)
                    if padded:
                        torch.nn.functional.pad(x, (0, ld - f - 4))

                t = dict(ms=time_device_ms(fused),
                         plain_ms=time_device_ms(plain),
                         assembly_ms=time_device_ms(assembly),
                         f_alone_ms=time_device_ms(f_alone),
                         library_sequence_ms=(None if scales is not None
                                              else time_device_ms(library)),
                         library_ms=None, back_to_back_ms=time_ms(fused))
                t["g_marginal_ms"] = t["ms"] - t["f_alone_ms"]
                t["bound_ms"], t["bound_by"] = bound(
                    image_bytes(b, k, f, ld, dtype, nd), 0.0)
                if scales is None:
                    t["spread"] = gather_spread({
                        "fused_ms": fused, "assembly_ms": assembly,
                        "F_ms": f_alone, "library_sequence_ms": library})
                key = f"{label} B={b} {'padded' if padded else 'contiguous'}"
                detail[key] = t
                if label == "bf16" and b == TRAIN_B and not padded:
                    entries.append(entry("gather_image_rows", t, counts,
                                         errs))
        del table, scales
        torch.cuda.empty_cache()
    del boxes
    torch.cuda.empty_cache()
    print("image gather timing detail (bf16 nodes, device times from CUDA "
          "events, launches queued behind a sleep kernel; ms = "
          "gather_image_rows, one launch; plain = gather_image_reference; "
          "assembly = the replaced F + G + cast + torch.cat, or F + G + "
          "padded_rows; f_alone = F on the same rows; g_marginal = ms - "
          "f_alone; library_sequence = two index_selects + the boxes' cast "
          "+ torch.cat (+ F.pad for padded rows); library_ms null: no one "
          "call; spread = fused, assembly, F and the library sequence timed "
          "6 times each in turns, each a median of 50 samples; bound = bytes "
          "read + written at 3.35 TB/s): " + json.dumps(detail), flush=True)
    return entries


def random_index_batch(b, cfg, n_images, rng):
    """An index batch as the Batcher yields it: random questions, image
    rows and sparse labels (3 answers a row), the last row padding."""
    s, pad = 16, cfg.out_dim - 1
    ans_idx = np.full((b, s), pad, np.int32)
    ans_score = np.zeros((b, s), np.float32)
    vote_val = np.zeros((b, s), np.float32)
    for i in range(b):
        ans_idx[i, :3] = rng.choice(pad, size=3, replace=False)
        ans_score[i, :3] = rng.uniform(0.3, 1.0, size=3)
        vote_val[i, :3] = rng.integers(1, 10, size=3)
    mask = np.ones((b,), np.float32)
    mask[-1] = 0.0
    return {"question": rng.integers(1, cfg.vocab_size, (b, cfg.max_qlen)
                                     ).astype(np.int32),
            "qlen": rng.integers(3, 15, b).astype(np.int32),
            "image_row": rng.integers(0, n_images, b).astype(np.int32),
            "ans_idx": ans_idx, "ans_score": ans_score,
            "vote_idx": ans_idx.copy(), "vote_val": vote_val, "mask": mask}


def random_cache(dev, n_images):
    """A bf16 device cache of n_images random images at full width, with
    f32 boxes."""
    return (random_table(n_images, 36, FULL["feat_dim"] - 4, torch.bfloat16,
                         dev),
            torch.cat([torch.rand(n_images, 36, 2, device=dev) * 0.5,
                       0.55 + torch.rand(n_images, 36, 2, device=dev) * 0.45],
                      -1))


def median_step_ms(step, n):
    """Median host-clock ms of n calls of step (each ending in a fetch),
    after 3 warm-up calls."""
    for _ in range(3):
        step()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def time_cache_steps(dev, gen, n=10, n_images=4096):
    """Phase 6, the cache part, steps: the full-width bf16 training step
    (dropout 0.5) in host mode and with a bf16 device cache of n_images
    images, in turns (host, cache, cache, host), at B=64 and 256; each
    step ends in a fetch of its loss (host clock). Profiles the cache
    step at B=64."""
    cfg = ModelConfig(**FULL)
    cache = random_cache(dev, n_images)
    image_fn = make_image_fn(cache, cfg.compute_dtype)
    rng = np.random.default_rng(SEED + 3)
    out = {}
    for b in (TRAIN_B, 256):
        model = GraphVQAModel(cfg, device=dev, seed=SEED)
        optimizer, _ = make_optimizer(model, TrainConfig(), 100)
        generator = torch.Generator(device=dev).manual_seed(SEED)
        dense = random_train_batch(b, cfg, gen)
        index = pack_index_batch(random_index_batch(b, cfg, n_images, rng))

        def host_step():
            float(train_step(model, optimizer, None, dense, generator)["loss"])

        def cache_step():
            float(train_step(model, optimizer, None, index, generator,
                             image_fn)["loss"])

        runs = [("host", host_step), ("cache", cache_step),
                ("cache", cache_step), ("host", host_step)]
        ms = {"host": [], "cache": []}
        for mode, step in runs:
            ms[mode].append(median_step_ms(step, n))
        out[b] = ms
        if b == TRAIN_B:
            profile(cache_step, f"the bf16 cache-mode training step at B={b}",
                    n=5)
    print("train step, host mode vs device cache (ms, host clock, median of "
          f"{n} steps each, run host, cache, cache, host): "
          + json.dumps({f"B={b}": v for b, v in out.items()}), flush=True)
    del cache
    torch.cuda.empty_cache()
    return out


def time_evaluate(dev, model, ds, cache):
    """Phase 6, the cache part: evaluate()'s throughput on the trainval
    split, resident (device cache) and streaming (host mode), each timed
    on its second call."""
    split = ds["trainval"]
    out = {}
    for mode, kw in (("resident", {"cache": cache}),
                     ("streaming", {"cache": None})):
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            evaluate(model, split, TRAIN_B, result_path=None, device=dev,
                     **kw)
            wall = time.perf_counter() - t0
        out[mode] = split.n_questions / wall
    print(f"evaluate throughput, trainval split ({split.n_questions} "
          f"questions, batch {TRAIN_B}, second call, host clock): "
          f"resident {out['resident']:.1f} questions/s, streaming "
          f"{out['streaming']:.1f} questions/s", flush=True)
    return out


# ---------------- the merged block: kernels H and I ----------------


def block_inputs(b, k, m, gen, dev, n=8, d1=None, d2=None):
    """Kernel H's inputs, by default at the VQA v2 widths (F1 2052, d1
    2 hid / n, d2 hid / n): an adjacency, pseudo from box centres, region
    features (contiguous), the convs' torch-default projections side by
    side (W1cat (F1, n d1), W2cat (n d1, n d2), f32), gparams from the
    init ranges and seeds."""
    f1, hid = FULL["feat_dim"], FULL["hid_dim"]
    d1, d2 = d1 or 2 * hid // n, d2 or hid // n

    def u(rows, cols):
        return (torch.rand(rows, cols, generator=gen) * 2 - 1) / math.sqrt(
            rows)

    def gp():
        return torch.stack([
            torch.rand(n, generator=gen),
            (torch.rand(n, generator=gen) * 2 - 1) * math.pi,
            torch.rand(n, generator=gen), torch.rand(n, generator=gen)])

    adj = torch.randn(b, k, k, generator=gen)
    pseudo = polar_pseudo_coords(bbox_centres(random_boxes(b, k, gen)))
    feats = torch.randn(b, k, f1, generator=gen)
    xs = [t.contiguous().to(dev) for t in (adj, pseudo, feats, u(f1, n * d1),
                                           u(n * d1, n * d2), gp(), gp())]
    return xs + [random_seeds(b, gen, dev)]


def block_gemm_shapes(b, k=36):
    """The block's six products at B*K rows: (label, layout, a shape,
    b shape), operands row-major as tile_gemm takes them."""
    r, f1, nd1, nd2 = b * k, FULL["feat_dim"], 2 * FULL["hid_dim"], \
        FULL["hid_dim"]
    return [("proj1 = feats W1", "nn", (r, f1), (f1, nd1)),
            ("proj2 = h1 W2", "nn", (r, nd1), (nd1, nd2)),
            ("dW2 = h1^T dp2", "tn", (r, nd1), (r, nd2)),
            ("dh1 = dp2 W2^T", "nt", (r, nd2), (nd1, nd2)),
            ("dW1 = feats^T dp1", "tn", (r, f1), (r, nd1)),
            ("dfeats = dp1 W1^T", "nt", (r, nd1), (f1, nd1))]


def library_mm(a, b, layout):
    """One torch.mm (cuBLAS) of the same product, f32 out: the yardstick
    for tile_gemm (bf16 operands: f32 sums, as the hand GEMM)."""
    a = a.t() if layout == "tn" else a
    b = b.t() if layout == "nt" else b
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    return torch.mm(a, b, out_dtype=torch.float32)


def check_tile_gemm(dev, gen):
    """Phase 13: the bare GEMM against torch.mm in each layout at the
    block's six product shapes (B=64) and at B*K = 408 (B=8, K=51), f32
    (exact SIMT) and bf16 (tensor cores); its epilogues."""
    worst = 0.0
    for b, k in ((TRAIN_B, 36), (8, 51)):
        for label, layout, sa, sb in block_gemm_shapes(b, k):
            a = torch.randn(*sa, generator=gen).to(dev)
            bm = torch.randn(*sb, generator=gen).to(dev)
            errs = []
            for dtype in (torch.float32, torch.bfloat16):
                x, y = a.to(dtype), bm.to(dtype)
                got = tile_gemm(x, y, layout)
                want = library_mm(x.float(), y.float(), layout)
                errs.append(norm_err(got, want))
            torch.cuda.synchronize()
            worst = max(worst, errs[1])
            print(f"tile_gemm {layout} {label} a{sa} b{sb}: normalized err "
                  f"vs torch.mm f32 {errs[0]:.2e}, bf16 operands "
                  f"{errs[1]:.2e} (<= 1e-5)", flush=True)
            require(max(errs) <= 1e-5, f"tile_gemm {layout} {label} disagrees")
    # epilogues: the relu/dropout gate and the operand-dtype store
    _, layout, sa, sb = block_gemm_shapes(TRAIN_B)[3]
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.randn(*sa, generator=gen).to(dev, dtype)
        bm = torch.randn(*sb, generator=gen).to(dev, dtype)
        gate = torch.randn(sa[0], sb[0], generator=gen).to(dev, dtype)
        got = tile_gemm(a, bm, layout, "gate", gate, 2.0)
        want = tile_gemm_reference(a, bm, layout, "gate", gate, 2.0)
        got_t = tile_gemm(a, bm, layout, "operand")
        want_t = tile_gemm_reference(a, bm, layout, "operand")
        torch.cuda.synchronize()
        e_g, e_t = norm_err(got, want), norm_err(got_t, want_t)
        print(f"tile_gemm epilogues {str(dtype)[6:]}: gate {e_g:.2e} (<= "
              f"1e-5), operand dtype {e_t:.2e} (<= {8e-3 if dtype != torch.float32 else 1e-5}); "
              f"zeros where gate <= 0: "
              f"{bool((got[gate.float() <= 0] == 0).all())}", flush=True)
        require(e_g <= 1e-5 and got_t.dtype == dtype
                and e_t <= (1e-5 if dtype == torch.float32 else 8e-3)
                and bool((got[gate.float() <= 0] == 0).all()),
                "tile_gemm epilogues disagree")
    return worst


# kernel H's wgmma tiles (BM, BN); (0, 0) is the rule's pick
WGMMA_TILES = ((128, 128), (128, 256), (192, 192), (0, 0))


def wgmma_tol(k):
    """Normalized tolerance of a wgmma product of depth k against one
    torch.mm: 1e-5 up to k = 2052, the deepest of H's products (PR 8),
    then in proportion to k. The tensor cores' f32 accumulator is not
    rounded to nearest at each k16 step, so the two products'
    difference grows linearly with the depth: I's TN products reduce
    over B*K rows (9252 at B=257)."""
    return 1e-5 * max(1.0, k / 2052)


def check_wgmma_gemm(dev, gen):
    """Phase 13: the wgmma product against torch.mm (f32 sums of the same
    bf16 operands) at the block's six products (block_gemm_shapes),
    B*K = 36, 408, 2304 and 9252 rows, every tile (WGMMA_TILES), within
    wgmma_tol (1e-5 up to a depth of 2052) normalized, and a second run
    equal bit for bit: H's NN proj1 (A a view of rows padded to 2056)
    and proj2, then I's TN dW2 and dW1
    (A a view of padded rows) and NT dh1 and dfeats, the last two also
    through their epilogues (I's relu/dropout gate, the bf16 store)
    against tile_gemm_reference. I's products draw from their own
    generator, so that H's and I's later inputs stay those of earlier
    runs."""
    worst = 0.0
    gen_i = torch.Generator().manual_seed(SEED + 13)
    for b, k in ((1, 36), (8, 51), (TRAIN_B, 36), (257, 36)):
        for i, (label, layout, sa, sb) in enumerate(block_gemm_shapes(b, k)):
            g_ = gen if i < 2 else gen_i
            a = torch.randn(sa[0], 1, sa[1], generator=g_).to(dev)
            a = (padded_rows([a], torch.bfloat16)[:, 0]
                 if label.startswith(("proj1", "dW1"))
                 else a[:, 0].to(torch.bfloat16))
            w = torch.randn(*sb, generator=g_).to(dev, torch.bfloat16)
            want = library_mm(a.float(), w.float(), layout)
            depth = sa[0] if layout == "tn" else sa[1]
            epilogues = [("f32", None, 1.0)]
            if label.startswith("dh1"):
                gate = torch.randn(*want.shape, generator=gen_i).to(
                    dev, torch.bfloat16)
                epilogues.append(("gate", gate, 1.0 / (1.0 - DROPOUT)))
            elif label.startswith("dfeats"):
                epilogues.append(("operand", None, 1.0))
            for tile in WGMMA_TILES:
                for epilogue, gate, scale in epilogues:
                    got = wgmma_gemm(a, w, tile, layout, epilogue, gate,
                                     scale)
                    again = wgmma_gemm(a, w, tile, layout, epilogue, gate,
                                       scale)
                    ref = (want if epilogue == "f32" else
                           tile_gemm_reference(a, w, layout, epilogue, gate,
                                               scale))
                    torch.cuda.synchronize()
                    e = norm_err(got, ref)
                    tol = 8e-3 if epilogue == "operand" else wgmma_tol(depth)
                    if epilogue != "operand":
                        worst = max(worst, e)
                    same = torch.equal(got, again)
                    extra = ""
                    if epilogue == "gate":
                        zeros = bool((got[gate.float() <= 0] == 0).all())
                        extra = f"; zeros where gate <= 0 {zeros}"
                        same = same and zeros
                    print(f"wgmma_gemm {layout} {label} a{tuple(a.shape)} "
                          f"(row stride {a.stride(0)}) b{sb} tile {tile} "
                          f"epilogue {epilogue}: normalized err vs "
                          f"{'torch.mm' if epilogue == 'f32' else 'plain'} "
                          f"{e:.2e} (<= {tol:.3g}); rerun equal bit for bit "
                          f"{torch.equal(got, again)}{extra}", flush=True)
                    require(e <= tol and same, f"wgmma_gemm {layout} {label} "
                            f"{tile} {epilogue} disagrees")
            del a, w, want
    return worst


# kernel H's and I's shapes: (label, B, K, m, n, d1, d2); d1 = d2 = None
# are the VQA widths. "tile rule" has n d2 = 36, not a multiple of 8, so
# its bf16 products with an n d2-wide operand (H's proj2, I's dW2 and dh1)
# go to tile_gemm (wgmma_gemm::fits) and the others (H's proj1, I's dW1
# and dfeats) to wgmma.
BLOCK_SHAPES = [("vqa", TRAIN_B, 36, 16, 8, None, None),
                ("medical", 8, 51, 19, 8, None, None),
                ("B=1", 1, 36, 16, 8, None, None),
                ("B=257", 257, 36, 16, 8, None, None),
                ("n=1", 8, 36, 16, 1, None, None),
                ("d1=40", 8, 36, 16, 8, 40, 20),
                ("tile rule", 8, 36, 16, 4, 18, 9)]


def projection_products(fn, marker, n=3, tries=10, held=2):
    """The products that `n` calls of `fn` launched, read from profiles
    (torch.profiler): (a subset of {"wgmma" (wgmma_gemm.cuh's
    gemm_kernel, every layout), "tile" (tile_gemm.cuh)}, the number of
    profiles taken). A profile that follows others in one process was
    seen to drop a kernel's event, and others to come back empty, three
    in a row once; so a profile is read only where it holds `marker`,
    a kernel that `fn` launches beside its products on every call, and
    the products of up to `tries` fresh profiles are joined until `held`
    of them were read. No profile read gives an empty set."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    kinds, read = set(), 0
    for taken in range(1, tries + 1):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        names = [evt.name for evt in prof.events()
                 if evt.device_type == torch.autograd.DeviceType.CUDA]
        if any(marker in name for name in names):
            read += 1
            for name in names:
                if "wgmma_gemm::gemm_kernel" in name:
                    kinds.add("wgmma")
                elif "wmma_gemm_kernel" in name or "f32_gemm_kernel" in name:
                    kinds.add("tile")
        if read == held:
            break
        time.sleep(0.05)
    return kinds, taken


def check_graph_block(dev, gen, errs):
    """Phase 13, kernels H and I: every output against the plain version
    on the same inputs (I from H's residuals), f32 and bf16, with conv1's
    dropout at 0.5, at BLOCK_SHAPES; feats both as a view of padded rows
    (the model's) and contiguous (the wrapper pads a copy), the two equal
    bit for bit, and reruns of H and I into NaN-filled outputs equal bit
    for bit; the products H and I launched asserted (projection_products);
    at n = 1 (precisions from [0.5, 1), every Gaussian above the 1e-20
    clamp) I's dpseudo and dgparams exactly 0, as the plain version's;
    in f32 H's h1 equal to kernel C's output bit for bit for the
    same alpha, f32 projection and seeds (the same Philox mask); the mask
    equal to the plain selection's."""
    for label, b, k, m, n, d1, d2 in BLOCK_SHAPES:
        adj, pseudo, feats, w1cat, w2cat, gp1, gp2, seeds = block_inputs(
            b, k, m, gen, dev, n, d1, d2)
        if n == 1:
            # the shape holds the cancellation of every pseudo and gparams
            # term where ghat is 1: precisions from [0.5, 1) keep each
            # edge's single Gaussian above the 1e-20 clamp (from [0, 1) it
            # fell below it on every edge: nothing left to cancel)
            for gp in (gp1, gp2):
                gp[2:] = 0.5 + 0.5 * gp[2:]
        g = torch.randn(b, k, w2cat.shape[1], generator=gen).to(dev)
        for dtype, tol_h, tol_i in ((torch.float32, 1e-5, 1e-5),
                                    (torch.bfloat16, 1e-2, 1e-2)):
            x = padded_rows([feats], dtype)
            w1, w2 = w1cat.to(dtype), w2cat.to(dtype)
            pick, taken = projection_products(lambda: graph_block_fwd(
                adj, pseudo, x, w1, w2, gp1, gp2, seeds, m, DROPOUT),
                "block_conv_kernel")
            want_pick = ({"tile"} if dtype == torch.float32
                         else {"wgmma", "tile"} if label == "tile rule"
                         else {"wgmma"})
            require(pick == want_pick,
                    f"kernel H launched products {pick} at {label} {dtype} "
                    f"({taken} profiles; an empty set: no profile held H), "
                    f"not {want_pick}")
            res = graph_block_fwd(adj, pseudo, x, w1, w2, gp1, gp2, seeds, m,
                                  DROPOUT)
            dense = graph_block_fwd(adj, pseudo, feats.to(dtype), w1, w2,
                                    gp1, gp2, seeds, m, DROPOUT)
            nan = BlockResiduals(*(torch.full_like(t, float("nan"))
                                   for t in res))
            rerun = graph_block_fwd(adj, pseudo, x, w1, w2, gp1, gp2, seeds,
                                    m, DROPOUT, out=nan)
            ref = graph_block_fwd_reference(adj, pseudo, x, w1, w2, gp1, gp2,
                                            seeds, m, DROPOUT)
            bargs = (g, res, pseudo, x, w1, w2, gp1, gp2, DROPOUT)
            pick_i, taken_i = projection_products(
                lambda: graph_block_bwd(*bargs, need_dfeats=True),
                "block_bwd_dot_kernel")
            require(pick_i == want_pick,
                    f"kernel I launched products {pick_i} at {label} "
                    f"{dtype} ({taken_i} profiles; an empty set: no profile "
                    f"held I), not {want_pick}")
            grads = graph_block_bwd(*bargs, need_dfeats=True)
            nan_g = BlockGrads(*(torch.full_like(t, float("nan"))
                                 for t in grads))
            rerun_g = graph_block_bwd(*bargs, need_dfeats=True, out=nan_g)
            ref_g = graph_block_bwd_reference(*bargs, need_dfeats=True)
            torch.cuda.synchronize()
            e_h = {f: norm_err(x_, y) for f, x_, y in zip(res._fields, res,
                                                           ref)}
            e_i = [norm_err(x_, y) for x_, y in zip(grads, ref_g)]
            same_mask = torch.equal(res.mask, ref.mask)
            same_dense = all(torch.equal(p, q) for p, q in zip(res, dense))
            same_nan = all(torch.equal(p, q) for p, q in zip(res, rerun))
            same_nan_i = all(torch.equal(p, q) for p, q in zip(grads,
                                                                 rerun_g))
            # n = 1: on every edge whose Gaussian clears the 1e-20 clamp in
            # both convs, ghat is 1 and each pseudo term cancels exactly (the
            # kernel rounds the cross term as the plain version does); an
            # edge below the clamp has ghat = w / 1e-20 and a true, nonzero
            # gradient, summed into dgp in another order than the plain one
            clear = (res.den1 > 1e-20) & (res.den2 > 1e-20)
            cancels = bool((grads.dpseudo[clear] == 0).all()
                           and (ref_g.dpseudo[clear] == 0).all())
            exact = {f: float((getattr(grads, f) - getattr(ref_g, f)).abs()
                              .max()) for f in ("dpseudo", "dgp1", "dgp2")}
            print(f"kernel H {label} B={b} K={k} m={m} n={n} "
                  f"d1={w1.shape[1] // n} d2={w2.shape[1] // n} "
                  f"{str(dtype)[6:]} dropout {DROPOUT}, projections "
                  f"{'/'.join(sorted(pick))} ({taken} profiles): normalized "
                  f"err "
                  + ", ".join(f"{f} {e:.2e}" for f, e in e_h.items())
                  + f" (<= {tol_h}); mask equal {same_mask}; contiguous "
                  f"feats equal bit for bit {same_dense}; NaN-filled rerun "
                  f"equal bit for bit {same_nan}; kernel I, products "
                  f"{'/'.join(sorted(pick_i))} ({taken_i} profiles): "
                  f"dadj/dpseudo/dfeats/dW1/dW2/dgp1/dgp2 "
                  + "/".join(f"{e:.2e}" for e in e_i)
                  + f" (<= {tol_i}); NaN-filled rerun equal bit for bit "
                  f"{same_nan_i}; max abs difference of dpseudo/dgp1/dgp2 "
                  + "/".join(f"{e:.3e}" for e in exact.values())
                  + (f"; n = 1: dpseudo exactly 0 in kernel and plain on the "
                     f"{int(clear.sum())} edges above the clamp {cancels} "
                     f"({int((~clear).sum())} below it)"
                     if label == "n=1" else ""), flush=True)
            require(same_mask and max(e_h.values()) <= tol_h,
                    f"kernel H {label} {dtype} disagrees")
            require(same_dense and same_nan,
                    f"kernel H {label} {dtype} is not repeatable")
            require(max(e_i) <= tol_i, f"kernel I {label} {dtype} disagrees")
            require(same_nan_i, f"kernel I {label} {dtype} is not repeatable")
            require(label != "n=1" or (cancels and bool(clear.all())
                                       and max(exact.values()) == 0),
                    f"kernel I's n = 1 pseudo and gparams gradients do not "
                    f"cancel: {exact}")
            if label == "vqa" and dtype == torch.bfloat16:
                errs["graph_block_fwd"] = max(
                    float((x_.float() - y.float()).abs().max())
                    for x_, y in zip(res, ref))
                errs["graph_block_bwd"] = max(
                    float((x_.float() - y.float()).abs().max())
                    for x_, y in zip(grads, ref_g))
            if dtype != torch.float32:
                continue
            c_out = sel_aggregate_act_residuals(
                res.alpha, pseudo, res.proj1.view(b, k, -1), gp1, True,
                DROPOUT, seeds)[0]
            plain = sel_aggregate_act_residuals_reference(
                res.alpha, pseudo, res.proj1.view(b, k, -1), gp1, True)[0]
            keep = philox_keep(seeds, plain.shape[1:], DROPOUT)
            clear = plain > 1e-6 * float(plain.max())
            mismatched = int(((res.h1 != 0) != keep)[clear].sum())
            torch.cuda.synchronize()
            print(f"kernel H {label} conv1 dropout: h1 equal to kernel C's "
                  f"output bit for bit {torch.equal(c_out, res.h1)}; mask "
                  f"mismatches vs plain Philox {mismatched} of "
                  f"{int(clear.sum())} (want 0)", flush=True)
            require(torch.equal(c_out, res.h1) and mismatched == 0,
                    "kernel H's dropout differs from kernel C's")
        del adj, pseudo, feats, w1cat, w2cat, res, dense, rerun, ref, grads
        del rerun_g, nan_g, bargs
        torch.cuda.empty_cache()


def block_bound(adj, feats, w1cat, w2cat, n, m):
    """Kernel H: inputs read once (adj, pseudo, feats, both weights,
    gparams, seeds) and out, h1, alpha, mask, den1, den2, ghat1, ghat2
    written; the two projections at the operands' peak, the two K x K
    aggregations, the Gaussians and the K^3 rank at the f32 rate."""
    b, k, f1 = feats.shape
    nd1, nd2 = w2cat.shape
    es = feats.element_size()
    nbytes = (b * k * k * 4 * 3 + feats.numel() * es
              + (w1cat.numel() + w2cat.numel()) * es + 2 * 4 * n * 4 + b * 4
              + b * k * (nd1 + nd2) * es + b * k * k * 4 * (4 + 2 * n))
    ops_s = (2 * b * k * (f1 * nd1 + nd1 * nd2) / PEAK_FLOPS[feats.dtype]
             + (2 * b * k * k * (nd1 + nd2) + 2 * GAUSS_FLOPS * b * k * k * n
                + b * k * k * k) / PEAK_FLOPS[torch.float32])
    return nbytes, ops_s


def block_vjp_bound(feats, w1cat, w2cat, n, need_dfeats):
    """Kernel I: g (f32), out, h1, feats, both weights, the f32
    projections and H's K x K residuals read once; dadj, dpseudo, dW1,
    dW2 (f32), dfeats if asked and the gparams partials written; the
    products dW2, dh1, dW1 (and dfeats) at the operands' peak, the two
    aggregation backwards (two K x K x n d products each) and ~40 flops
    per edge and kernel at the f32 rate."""
    b, k, f1 = feats.shape
    nd1, nd2 = w2cat.shape
    es = feats.element_size()
    rows = b * k
    nbytes = (rows * nd2 * (4 + es) + rows * nd1 * es + feats.numel() * es
              + (w1cat.numel() + w2cat.numel()) * es
              + rows * (nd1 + nd2) * 4 + b * k * k * 4 * (4 + 2 * n + 2)
              + b * k * k * 4 * 3 + (f1 * nd1 + nd1 * nd2) * 4
              + (feats.numel() * es if need_dfeats else 0) + 2 * b * 4 * n * 4)
    gemm = 2 * rows * (2 * nd1 * nd2 + f1 * nd1 * (2 if need_dfeats else 1))
    ops_s = (gemm / PEAK_FLOPS[feats.dtype]
             + (4 * b * k * k * (nd1 + nd2) + 2 * 40 * b * k * k * n)
             / PEAK_FLOPS[torch.float32])
    return nbytes, ops_s


def kernel_rows(fn, n=10):
    """Device ms per call of each kernel that `fn` launches
    (torch.profiler), largest first."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a profile after others may come back empty
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [[evt.self_device_time_total / n / 1e3, evt.key[:60]]
                for evt in prof.key_averages()
                if evt.device_type == torch.autograd.DeviceType.CUDA
                and evt.self_device_time_total > 0]
        if rows:
            break
    return sorted(rows, reverse=True)


def time_products(dev, gen, b, x):
    """The block's six products at B*K rows (H's two NN, I's TN dW2 and
    dW1 and NT dh1 and dfeats): the wgmma product in each of WGMMA_TILES
    (proj1 and dW1 from the padded view x; dh1 through I's gate, dfeats
    storing bf16), tile_gemm (contiguous operands, the same epilogue) and
    one torch.mm of the same bf16 operands (f32 out, no epilogue), beside
    the bound."""
    bf = torch.bfloat16
    out = {}
    for label, layout, sa, sb in block_gemm_shapes(b):
        a_ = (x.reshape(-1, x.shape[-1]) if label.startswith(("proj1", "dW1"))
              else torch.randn(*sa, generator=gen).to(dev, bf))
        a_dense = a_.contiguous()
        b_ = torch.randn(*sb, generator=gen).to(dev, bf)
        mm, kk = (sa[1], sa[0]) if layout == "tn" else sa
        nn = sb[0] if layout == "nt" else sb[1]
        ep = ("gate", torch.randn(mm, nn, generator=gen).to(dev, bf),
              1.0 / (1.0 - DROPOUT)) if label.startswith("dh1") else (
            ("operand", None, 1.0) if label.startswith("dfeats")
            else ("f32", None, 1.0))
        t = {f"wgmma_{bm}x{bn}_ms": time_device_ms(
            lambda tile=(bm, bn): wgmma_gemm(a_, b_, tile, layout, *ep))
             for bm, bn in WGMMA_TILES}
        t["tile_gemm_ms"] = time_device_ms(
            lambda: tile_gemm(a_dense, b_, layout, *ep))
        t["library_ms"] = time_device_ms(lambda: library_mm(a_, b_, layout))
        out_bytes = (2 if ep[0] == "operand" else 4) * mm * nn
        t["bound_ms"], t["bound_by"] = bound(
            2 * (a_.numel() + b_.numel()) + out_bytes
            + (2 * mm * nn if ep[0] == "gate" else 0),
            2 * mm * nn * kk / PEAK_FLOPS[bf])
        t["wgmma_tflops"] = {
            f"{bm}x{bn}": 2 * mm * nn * kk / t[f"wgmma_{bm}x{bn}_ms"] / 1e9
            for bm, bn in WGMMA_TILES}
        out[f"{layout} {label} ({mm}x{nn}x{kk})"] = t
        del a_, a_dense, b_, ep
    return out


def time_graph_block(dev, gen, counts, errs):
    """Phase 6, the merged block's part: H and I at B=64 (the main path)
    and 256, beside their plain versions and bounds, H with feats as the
    model hands them (a view of padded rows) and as a contiguous
    2052-wide tensor (the wrapper's padded copy in its time), H's and
    I's launches one by one; the block's six products on the wgmma
    product in every tile beside tile_gemm and one torch.mm each; the
    merged block's forward + backward beside the unmerged one (cuBLAS
    projections + C + D, selection by masked_neighbourhood) in turns."""
    entries, detail = [], {}
    bf = torch.bfloat16
    n = FULL["n_kernels"]
    for b in (TRAIN_B, 256):
        adj, pseudo, feats, w1cat, w2cat, gp1, gp2, seeds = block_inputs(
            b, 36, 16, gen, dev)
        x, w1, w2 = padded_rows([feats], bf), w1cat.to(bf), w2cat.to(bf)
        dense = feats.to(bf)
        fargs = (adj, pseudo, x, w1, w2, gp1, gp2, seeds, 16, DROPOUT)
        res = graph_block_fwd(*fargs)
        g = torch.randn(b, 36, w2.shape[1], generator=gen).to(dev)
        bargs = (g, res, pseudo, x, w1, w2, gp1, gp2, DROPOUT)
        h = timed(lambda: graph_block_fwd(*fargs),
                  lambda: graph_block_fwd_reference(*fargs),
                  *block_bound(adj, x, w1, w2, n, 16))
        h["contiguous_feats_ms"] = time_device_ms(lambda: graph_block_fwd(
            adj, pseudo, dense, *fargs[3:]))
        h["launches_ms"] = kernel_rows(lambda: graph_block_fwd(*fargs))
        i = timed(lambda: graph_block_bwd(*bargs, need_dfeats=False),
                  lambda: graph_block_bwd_reference(
                      *bargs, need_dfeats=False),
                  *block_vjp_bound(x, w1, w2, n, False))
        i["launches_ms"] = kernel_rows(
            lambda: graph_block_bwd(*bargs, need_dfeats=False))
        i_dfeats = time_device_ms(lambda: graph_block_bwd(*bargs))
        products = time_products(dev, gen, b, x)
        # I's products in one torch.mm each (without dfeats: the model's)
        i["products_library_ms"] = sum(
            t["library_ms"] for key, t in products.items()
            if key.split()[1] in ("dW2", "dh1", "dW1"))
        detail[f"B={b}"] = {"graph_block_fwd": h, "graph_block_bwd": i,
                            "graph_block_bwd_with_dfeats_ms": i_dfeats,
                            "products": products,
                            "block_fwd_bwd": block_fwd_bwd(
                                dev, gen, b, adj, pseudo, x, seeds, g)}
        if b == TRAIN_B:
            for name, t in (("graph_block_fwd", h), ("graph_block_bwd", i)):
                entries.append(entry(name, t, counts, errs))
        del res, fargs, bargs
        torch.cuda.empty_cache()
    print("merged block timing detail (bf16, dropout 0.5, device times "
          "behind a sleep kernel; H = 5 launches, I without dfeats = 7 "
          "launches and the partials' two sums, with = 8 (launches_ms: "
          "each kernel's device ms per call, torch.profiler), feats a view "
          "of rows padded to 2056 (contiguous_feats_ms: a contiguous "
          "2052-wide feats, the wrapper's padded copy included); "
          "products_library_ms = I's dW2, dh1 and dW1 in one torch.mm each; "
          "products = the block's six products on the wgmma product in "
          "each BM x BN tile (0x0 = the rule's pick) beside tile_gemm and "
          "one torch.mm (library), bf16 operands, f32 out, dh1 through I's "
          "gate and dfeats stored bf16 (torch.mm without them); "
          "block_fwd_bwd = forward + backward of both convs, merged vs "
          "unmerged, CUDA events back to back and device time, run "
          "unmerged, merged, merged, unmerged): " + json.dumps(detail),
          flush=True)
    return entries


def block_fwd_bwd(dev, gen, b, adj, pseudo, x, seeds, g):
    """Forward + backward of both graph convolutions at full width,
    merged (H + I) and unmerged (selection, cuBLAS projections, C + D),
    on the same weights, adjacency, features and seeds: ms of each, in
    turns (unmerged, merged, merged, unmerged)."""
    bf = torch.bfloat16
    n = FULL["n_kernels"]
    conv1 = GaussianGraphConv(FULL["feat_dim"], 2 * FULL["hid_dim"], n,
                              compute_dtype=bf)
    conv2 = GaussianGraphConv(2 * FULL["hid_dim"], FULL["hid_dim"], n,
                              compute_dtype=bf)
    wgen = torch.Generator().manual_seed(SEED)
    conv1.reset_parameters(wgen)
    conv2.reset_parameters(wgen)
    conv1.to(dev)
    conv2.to(dev)
    adj_p = adj.clone().requires_grad_(True)
    g16 = g.to(bf)

    def unmerged():
        alpha, mask = masked_neighbourhood(adj_p, 16)
        hg1 = conv1(x, alpha, pseudo, dropout_rate=DROPOUT, seeds=seeds)
        conv2(hg1, mask, pseudo).backward(g16)

    def merged():
        w1 = torch.stack([lin.weight.t() for lin in conv1.conv_weights])
        w2 = torch.stack([lin.weight.t() for lin in conv2.conv_weights])
        fused_graph_block(adj_p, pseudo, x, w1, conv1.gparams(), w2,
                          conv2.gparams(), seeds, 16, DROPOUT).backward(g16)

    out = {"unmerged": [], "merged": []}
    for name, fn in (("unmerged", unmerged), ("merged", merged),
                     ("merged", merged), ("unmerged", unmerged)):
        out[name].append({"events_ms": time_ms(fn, samples=10, reps=5),
                          "device_ms": time_device_ms(fn, samples=10,
                                                      reps=5)})
    return out


def merged_serving_forward(dev, gen, model16, n_batches=4):
    """Phase 14, serving: the bf16 forward at B=16 with the merged block
    on the serving model's weights launches H once and A never per
    forward, and picks the unmerged forward's answer on most rows (the
    block keeps the projections in f32 where the unmerged path rounds
    them to bf16; random weights leave near-ties)."""
    cfg = dataclasses.replace(model16.cfg, merged_block=True)
    merged = GraphVQAModel(cfg, device=dev, seed=SEED)
    merged.load_state_dict(model16.state_dict())
    same = total = 0
    worst = 0.0
    for _ in range(n_batches):
        batch = [x.to(dev) for x in random_batch(SERVE_B, cfg, gen)]
        reset_counts()
        logits_m, adj_m, _ = merged(*batch)
        torch.cuda.synchronize()
        counts = read_counts()
        logits_u, adj_u, _ = model16(*batch)
        require(counts["graph_block_fwd"] == 1
                and counts["edge_aggregate_fwd"] == 0
                and counts["gru_scan_fwd"] == 1,
                f"launches per merged forward {counts}")
        require(bool(torch.isfinite(logits_m).all())
                and torch.equal(adj_m, adj_u), "merged forward outputs")
        same += int((logits_m.argmax(-1) == logits_u.argmax(-1)).sum())
        total += SERVE_B
        worst = max(worst, norm_err(logits_m, logits_u))
    share = same / total
    print(f"serving forward B={SERVE_B} with the merged block: launches per "
          f"forward H 1, A 0, B 1; argmax equal to the "
          f"unmerged forward on {same}/{total} rows ({share:.4f}, >= 0.75); "
          f"logits normalized difference {worst:.3e}; adjacency equal",
          flush=True)
    require(share >= 0.75, "merged serving argmax agreement below 0.75")


def train_merged_main_path(dev, ds, cache, cache_losses):
    """Phase 14, this slice's main path: run_fit with the merged block and
    the bf16 device cache; per step H 1, I 1, A/C/D 0, B 1, E 16 + 1,
    F 1, G 1; step 1's loss (same weights, batch and dropout draws as
    phase 11) within 1e-2 relative of phase 11's: the block keeps the
    projections in f32, where the unmerged path rounds them to bf16."""
    model, losses, counts, _ = run_fit(dev, ds, cache, "merged block, "
                                       "device cache", merged=True)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, cache_losses)]
    print("relative loss difference from the unmerged cache mode (phase "
          "11), per step: " + json.dumps(rel), flush=True)
    require(rel[0] <= 1e-2, f"step 1's loss {losses[0]!r} is not within "
            f"1e-2 of phase 11's {cache_losses[0]!r}")
    return model, counts


def time_merged_steps(dev, n=10, n_images=4096):
    """Phase 6, the merged block's part: the full-width bf16 cache-mode
    training step (dropout 0.5) unmerged and merged on the same weights,
    in turns (unmerged, merged, merged, unmerged), at B=64 and 256; each
    step ends in a fetch of its loss (host clock). Profiles one merged
    step at B=64."""
    cfg = ModelConfig(**FULL)
    cache = random_cache(dev, n_images)
    rng = np.random.default_rng(SEED + 4)
    out = {}
    for b in (TRAIN_B, 256):
        index = pack_index_batch(random_index_batch(b, cfg, n_images, rng))
        steps = {}
        for merged in (False, True):
            model = GraphVQAModel(dataclasses.replace(cfg,
                                                      merged_block=merged),
                                  device=dev, seed=SEED)
            optimizer, _ = make_optimizer(model, TrainConfig(), 100)
            generator = torch.Generator(device=dev).manual_seed(SEED)
            image_fn = make_image_fn(cache, cfg.compute_dtype, merged)

            def step(model=model, optimizer=optimizer, generator=generator,
                     image_fn=image_fn):
                float(train_step(model, optimizer, None, index, generator,
                                 image_fn)["loss"])

            steps["merged" if merged else "unmerged"] = step

        ms = {"unmerged": [], "merged": []}
        for mode in ("unmerged", "merged", "merged", "unmerged"):
            ms[mode].append(median_step_ms(steps[mode], n))
        out[b] = ms
        if b == TRAIN_B:
            profile(steps["merged"], f"the bf16 merged-block cache-mode "
                    f"training step at B={b}", n=5)
        del steps
        torch.cuda.empty_cache()
    print("train step, unmerged vs merged block, device cache (ms, host "
          f"clock, median of {n} steps each, run unmerged, merged, merged, "
          "unmerged): " + json.dumps({f"B={b}": v for b, v in out.items()}),
          flush=True)
    del cache
    torch.cuda.empty_cache()
    return out


# ---------------- a JAX-layout checkpoint, written without flax --------


def jax_layout(sd) -> dict:
    """The JAX package's ``{"params": ...}`` tree (numpy, float32) of a
    mapping in the port's state_dict layout: the inverse of
    ``models/weights.py::state_dict_from_jax_params``, each conv's n
    Linears fused into one (in, n*d) kernel. Adam's moments, which
    mirror the parameters, take the same layout."""
    def a(name):
        return sd[name].detach().float().cpu().numpy()

    def weight_norm(prefix):
        return {"b": a(f"{prefix}.bias"), "g": a(f"{prefix}.weight_g")[:, 0],
                "v": np.ascontiguousarray(a(f"{prefix}.weight_v").T)}

    p = {"wembed": a("wembed.weight"), "gru_w_ih": a("q_gru.weight_ih_l0"),
         "gru_w_hh": a("q_gru.weight_hh_l0"),
         "gru_b_ih": a("q_gru.bias_ih_l0"), "gru_b_hh": a("q_gru.bias_hh_l0"),
         "adjacency_1": {name: weight_norm(f"adjacency_1.{name}")
                         for name in ("edge_layer_1", "edge_layer_2")},
         "out_1": weight_norm("out_1"), "out_2": weight_norm("out_2")}
    for conv in ("graph_convolution_1", "graph_convolution_2"):
        n = sd[f"{conv}.mean_rho"].shape[0]
        leaf = {g: a(f"{conv}.{g}")[:, 0] for g in (
            "mean_rho", "mean_theta", "precision_rho", "precision_theta")}
        leaf["conv_kernels"] = np.ascontiguousarray(np.concatenate(
            [a(f"{conv}.conv_weights.{i}.weight") for i in range(n)]).T)
        p[conv] = leaf
    return {"params": p}


def _msgpack_array(x):
    """flax's msgpack extension type 1 for a numpy array: a packed
    (shape, dtype name, C-order bytes)."""
    import msgpack

    if not isinstance(x, np.ndarray):
        raise TypeError(f"cannot pack {type(x)}")
    return msgpack.ExtType(1, msgpack.packb(
        (list(x.shape), x.dtype.name, x.tobytes("C")), use_bin_type=True))


def write_jax_checkpoint(path, model, optimizer, *, step, epoch,
                         extra=None) -> None:
    """``model``'s weights and ``optimizer``'s Adam state as the JAX
    package's ``save_checkpoint`` writes them, in flax's msgpack format:
    ``{params, opt_state: {"0": {count, mu, nu}, "1": {count}}, step,
    epoch, rng, extra}``, Adam's moments in float32 and its count as the
    schedule's too."""
    import msgpack

    names = {id(p): k for k, p in model.named_parameters()}
    moments = {"exp_avg": {}, "exp_avg_sq": {}}
    count = 0
    for param, state in optimizer.state.items():
        for key, table in moments.items():
            table[names[id(param)]] = state[key]
        count = int(state["step"])
    opt_count = np.asarray(count, np.int32)
    payload = {
        "params": jax_layout(model.state_dict()),
        "opt_state": {"0": {"count": opt_count,
                            "mu": jax_layout(moments["exp_avg"]),
                            "nu": jax_layout(moments["exp_avg_sq"])},
                      "1": {"count": opt_count}},
        "step": int(step), "epoch": int(epoch),
        "rng": np.zeros(4, np.uint32), "extra": dict(extra or {})}
    with open(path, "wb") as f:
        f.write(msgpack.packb(payload, default=_msgpack_array,
                              use_bin_type=True))


# ---------------- the CLI from files ----------------

REPO = os.path.dirname(os.path.abspath(__file__))
# `--synthetic` at full VQA v2 width: 512 images of 36 x 2048 f32 (151 MB
# as zlib zarr), a 3000-answer head over 1500 classes in binary, 12k
# question words, 2560 questions (train 1920: 30 steps of 64; val 640: 10
# batches; test 640); the model flags keep their defaults (hid 1024, 8
# kernels, 16 neighbours, K=36, bf16, dropout 0.5)
CLI_DATA = ["--synthetic", "--data_dir", "data", "--synthetic_feat_dim",
            "2048", "--synthetic_answers", "3000", "--synthetic_classes",
            "1500", "--synthetic_encoding", "binary", "--synthetic_vocab",
            "12000", "--synthetic_images", "512", "--synthetic_questions",
            "2560", "--bsize", str(TRAIN_B), "--num_devices", "1"]
# one resident evaluation batch: the image gather, A in both
# convolutions, B
EVAL_BATCH_LAUNCHES = {"gather_image_rows": 1, "edge_aggregate_fwd": 2,
                       "gru_scan_fwd": 1}


def check_blosc_fixtures() -> float:
    """Phase 15: the port's blosc decoder builds and decodes the
    committed frames of tests/fixtures/blosc/ to their bytes, bit for
    bit. Returns the build's seconds."""
    t0 = time.perf_counter()
    native.load_native()
    build_s = time.perf_counter() - t0
    folder = os.path.join(REPO, "tests", "fixtures", "blosc")
    with open(os.path.join(folder, "manifest.json")) as f:
        cases = json.load(f)
    for case in cases:
        with open(os.path.join(folder, case["name"] + ".blosc"), "rb") as f:
            frame = f.read()
        with open(os.path.join(folder, case["name"] + ".raw"), "rb") as f:
            raw = f.read()
        require(native.native_blosc_decompress(frame, len(raw)) == raw,
                f"blosc frame {case['name']} decoded wrongly")
    print(f"blosc decoder built in {build_s:.2f} s at "
          f"{native.native_lib_path()}; {len(cases)} committed frames "
          f"({', '.join(c['name'] for c in cases)}) decoded bit for bit",
          flush=True)
    return build_s


class _Tee(io.StringIO):
    """Standard output kept and still printed."""

    def write(self, text):
        sys.__stdout__.write(text)
        return super().write(text)


def cli_main(argv):
    """``cli.main(argv)`` in this process: (stdout, launch counts, wall
    seconds); the counts are set to 0 just before and read just after."""
    out = _Tee()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    torch.cuda.synchronize()
    return out.getvalue(), read_counts(), time.perf_counter() - t0


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _pack_mtimes(sdir):
    (meta, feat, box), _ = pack_paths(
        os.path.join(sdir, "trainval.zarr"),
        os.path.join(sdir, "trainval_boxes.zarr"),
        os.path.join(sdir, "trainval_image_size.csv"), FULL["n_obj"])
    return {p: os.stat(p).st_mtime_ns for p in (meta, feat, box)}


def cli_sizes():
    """(train steps an epoch, val batches, test questions) of CLI_DATA."""
    args, _, _ = cli.input_args(CLI_DATA)
    n_train = int(args.synthetic_questions * 0.75)
    return (n_train // args.bsize,
            -(-(args.synthetic_questions - n_train) // args.bsize),
            args.synthetic_questions // 4)


def cli_train(smi, cache_step_ms):
    """Phase 15, --train: two epochs; per step phase 11's launches
    (the two mini-validations' launches taken out), checkpoints per
    epoch, finite losses. Returns the median step ms."""
    out, counts, wall = cli_main(
        ["--train", *CLI_DATA, "--ep", "2", "--log_interval", "5",
         "--eval_interval", "20", "--save_dir", "run"])
    steps_per_epoch, val_batches, _ = cli_sizes()
    n_steps = 2 * steps_per_epoch
    per_step = dict(counts)
    for k, v in EVAL_BATCH_LAUNCHES.items():
        per_step[k] -= 2 * val_batches * v
    per_step = {k: v / n_steps for k, v in per_step.items()}
    recs = _records(os.path.join("run", "metrics.jsonl"))
    require(os.path.exists(os.path.join("run", "model_1.ckpt"))
            and os.path.exists(os.path.join("run", "model_2.ckpt")),
            "--train wrote no per-epoch checkpoints")
    require(len(recs) == n_steps // 5
            and all(math.isfinite(r["loss"]) for r in recs),
            f"--train's logged windows {recs}")
    require(out.count("Validation accuracy") == 2,
            "--train ran other than two mini-validations")
    # one window's ms per step, skipping the first window (warm-up)
    step_ms = [1e3 / r["steps_per_sec"] for r in recs[1:]]
    med = statistics.median(step_ms)
    print(f"--train (CLI, {smi}): {n_steps} steps at full width in "
          f"{wall:.3f} s with 2 mini-validations; losses "
          f"{recs[0]['loss']:.5f} -> {recs[-1]['loss']:.5f}, all finite; "
          f"median step {med:.3f} ms over windows 2-{len(recs)} of 5 steps "
          f"(host clock; phase 11's fit() median {cache_step_ms:.3f} ms); "
          f"launches {counts}, per train step {per_step}", flush=True)
    require(per_step == CACHE_STEP_LAUNCHES, f"launches per train step "
            f"{per_step}, want {CACHE_STEP_LAUNCHES}")
    return med


def cli_resume():
    """Phase 15, --train resumed from the epoch-1 checkpoint: its windows
    of epoch 2 equal the uninterrupted run's bit for bit."""
    cli_main(["--train", *CLI_DATA, "--ep", "2", "--log_interval", "5",
              "--eval_interval", "20", "--save_dir", "resumed",
              "--model_path", os.path.join("run", "model_1.ckpt")])
    keys = ("epoch", "step", "loss", "vqa_acc", "lr")
    want = [[r[k] for k in keys]
            for r in _records(os.path.join("run", "metrics.jsonl"))
            if r["epoch"] == 1]
    got = [[r[k] for k in keys]
           for r in _records(os.path.join("resumed", "metrics.jsonl"))
           if r["epoch"] == 1]
    require(len(want) == cli_sizes()[0] // 5 and got == want,
            f"the resumed run's epoch 2 {got} differs from the "
            f"uninterrupted run's {want}")
    print(f"--train --model_path run/model_1.ckpt: epoch 2's {len(got)} "
          f"windows (loss, accuracy, step, lr) equal the uninterrupted "
          f"run's bit for bit", flush=True)


def _cli_model(dev, ds, state_dict):
    """A fresh model of CLI_DATA's flags holding ``state_dict``."""
    mcfg, _ = cli.make_configs(cli.input_args(CLI_DATA)[0])
    model = build_model(mcfg, ds, device=dev)
    model.load_state_dict(state_dict)
    return model


def cli_eval_test(dev, smi, sdir):
    """Phase 15, --eval and --test from the epoch-2 checkpoint: the
    printed accuracy equals an in-process evaluate() of that checkpoint,
    result.json has one row per question, per batch the image gather 1,
    A 2, B 1. Returns (CLI questions/s, evaluate questions/s)."""
    ckpt = os.path.join("run", "model_2.ckpt")
    out, counts, wall = cli_main(["--eval", *CLI_DATA, "--model_path",
                                  ckpt])
    (acc,) = [float(line.split()[1]) for line in out.splitlines()
              if line.startswith("accuracy: ")]
    with open("result.json") as f:
        rows = json.load(f)
    val = GraphVQADataset.vqa2(sdir, "val")
    _, val_batches, n_test = cli_sizes()
    require(len(rows) == val.n_questions, f"--eval wrote {len(rows)} rows")
    want = {k: 0 for k in counts}
    want.update({k: val_batches * v for k, v in EVAL_BATCH_LAUNCHES.items()})
    require(counts == want, f"--eval launches {counts}, want {want}")
    model = _cli_model(dev, val, load_reference_checkpoint(ckpt))
    cache = make_feature_cache(val, TrainConfig(), model.cfg.compute_dtype,
                               dev)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc_in, result, _ = evaluate(model, val, TRAIN_B, result_path=None,
                                     cache=cache, device=dev)
        times.append(time.perf_counter() - t0)
    require(acc_in == acc and result == rows,
            f"--eval's accuracy {acc!r} or answers differ from evaluate()'s "
            f"{acc_in!r}")
    cli_qps = val.n_questions / wall
    eval_qps = val.n_questions / statistics.median(times)
    print(f"--eval (CLI, {smi}): accuracy {acc} % equal to evaluate() of "
          f"the checkpoint, {len(rows)} rows; launches {counts}; "
          f"{cli_qps:.1f} questions/s end to end ({wall:.3f} s: the "
          f"dataset, the model, the checkpoint, the cache upload and the "
          f"resident evaluation); evaluate() alone on a built cache "
          f"{eval_qps:.1f} questions/s (median of 3, host clock)",
          flush=True)
    out, _, _ = cli_main(["--test", *CLI_DATA, "--model_path", ckpt])
    with open("result.json") as f:
        rows = json.load(f)
    require(len(rows) == n_test and "accuracy" not in out,
            f"--test wrote {len(rows)} rows, want {n_test}, and no accuracy")
    print(f"--test: result.json holds {len(rows)} rows, no accuracy "
          f"printed", flush=True)
    return cli_qps, eval_qps


def cli_trainval(dev, sdir):
    """Phase 15, --trainval for one epoch: the named .pt loads through
    load_reference_checkpoint into a fresh model whose weights equal the
    trained model's bit for bit and which answers the val split as the
    trained one does."""
    args, _, unparsed = cli.input_args(["--trainval", *CLI_DATA, "--ep", "1",
                                        "--log_interval", "10",
                                        "--save_dir", "tv"])
    require(not unparsed, f"unparsed {unparsed}")
    trained, path, acc = cli.trainval(args)
    val = GraphVQADataset.vqa2(sdir, "val")
    fresh = _cli_model(dev, val, load_reference_checkpoint(path))
    weights = trained.state_dict()
    require(all(torch.equal(v, weights[k])
                for k, v in fresh.state_dict().items()),
            "the .pt's weights differ from the trained model's")
    got = evaluate(fresh, val, TRAIN_B, result_path=None, device=dev)
    want = evaluate(trained, val, TRAIN_B, result_path=None, device=dev)
    require(got[:2] == want[:2], "the .pt's model answers otherwise")
    print(f"--trainval --ep 1: {os.path.basename(path)} (epoch accuracy "
          f"{acc:.2f}%); a fresh model from load_reference_checkpoint "
          f"holds the trained weights bit for bit and answers the val "
          f"split as the trained one (accuracy "
          f"{got[0]:.4f}%, {len({r['answer'] for r in got[1]})} distinct "
          f"answers)", flush=True)


def cli_main_path(dev, smi, cache_step_ms):
    """Phase 15, the main path: the CLI from files, in the working
    directory (a temporary one, which phase 16 reuses)."""
    t_phase = time.perf_counter()
    check_blosc_fixtures()
    args, _, _ = cli.input_args(CLI_DATA)
    t0 = time.perf_counter()
    sdir = cli.synthetic_dir(args)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    FeatureStore.from_zarr(
        os.path.join(sdir, "trainval.zarr"),
        os.path.join(sdir, "trainval_boxes.zarr"),
        os.path.join(sdir, "trainval_image_size.csv"), FULL["n_obj"])
    pack_s = time.perf_counter() - t0
    packed = _pack_mtimes(sdir)
    size = os.path.getsize(next(p for p in packed if
                                p.endswith("_feat.npy")))
    print(f"synthetic set written as zlib zarr in {write_s:.3f} s; "
          f"pack of the {args.synthetic_images}-image store "
          f"({size / 1e6:.1f} MB f32) {pack_s:.3f} s ({smi})", flush=True)
    med = cli_train(smi, cache_step_ms)
    require(_pack_mtimes(sdir) == packed, "the CLI packed the store again")
    cli_resume()
    cli_qps, eval_qps = cli_eval_test(dev, smi, sdir)
    cli_trainval(dev, sdir)
    phase_s = time.perf_counter() - t_phase
    print(f"phase 15 in {phase_s:.1f} s ({smi}): " + json.dumps({
        "pack_s": pack_s, "fit_median_step_ms": med,
        "phase11_median_step_ms": cache_step_ms,
        "eval_cli_questions_per_s": cli_qps,
        "evaluate_questions_per_s": eval_qps}), flush=True)
    return sdir


# ---------------- the serving CLI from files ----------------

SERVE_JOBS = 64
# one served batch: kernel A in both convolutions, kernel B once
SERVE_BATCH_LAUNCHES = {"edge_aggregate_fwd": 2, "gru_scan_fwd": 1}
# the int8 products of one forward, in the order the forward runs them
INT8_PRODUCTS = ("edge_layer_1 (nodes)", "edge_layer_1 (question)",
                 "edge_layer_2", "graph_convolution_1",
                 "graph_convolution_2", "out_1", "out_2")
# top-1 agreement of int8 with bf16 serving: the JAX package's own bound
# (tests/test_model.py's quantized-inference test)
INT8_AGREEMENT = 0.9
# int8 against bf16 logits, relative to the largest: the JAX package's
# bound on int8 against f32 logits (the same test)
INT8_LOGIT_TOL = 0.15


def serve_from(label, path, b, jobs, smi, *extra):
    """``cli.serve.build_server`` of the checkpoint ``path`` at batch b
    with CLI_DATA's set and flags, ``jobs`` served over HTTP. The
    launches per served batch must be A 2, B 1 and nothing else.
    Returns (the server's model, the answers, p50 ms, p99 ms)."""
    t0 = time.perf_counter()
    srv = serve_cli.build_server(serve_cli.input_args(
        [*CLI_DATA, "--bsize", str(b), "--model_path", path, *extra]))
    build_s = time.perf_counter() - t0
    reset_counts()
    try:
        answers, lat, health, wall = http_serve(srv, jobs)
    finally:
        srv.close()
    counts = read_counts()
    n = health["batches_served"]
    want = {k: 0 for k in counts}
    want.update({k: n * v for k, v in SERVE_BATCH_LAUNCHES.items()})
    p50, p99 = p50_p99(lat)
    print(f"{label}: build_server {build_s:.3f} s (file, model, warm "
          f"forward); {len(jobs)} requests from 8 keep-alive clients in "
          f"{wall:.3f} s, {n} batches, latency p50 {p50:.2f} ms p99 "
          f"{p99:.2f} ms ({smi}); launches {counts}", flush=True)
    require(counts == want, f"{label}: launches {counts}, want {want} "
            f"(A 2 and B 1 per served batch)")
    return srv.model, [answers[i] for i in range(len(jobs))], p50, p99


@contextlib.contextmanager
def recording_int8(calls):
    """Within: each int8 product the model runs appends {x, w_q, w_scale,
    x_q, acc} (its float input, weights, codes and the int32 sums the
    card computed) to ``calls``."""
    real_mm, real_sums = quant.int8_matmul, quant.int8_sums

    def mm(x, w_q, w_scale):
        calls.append({"x": x, "w_q": w_q, "w_scale": w_scale})
        return real_mm(x, w_q, w_scale)

    def sums(x_q, w_q):
        acc = real_sums(x_q, w_q)
        calls[-1].update(x_q=x_q, acc=acc)
        return acc

    quant.int8_matmul, quant.int8_sums = mm, sums
    try:
        yield
    finally:
        quant.int8_matmul, quant.int8_sums = real_mm, real_sums


def int_mm_profile(fn, n=3):
    """(aten::_int_mm calls per call of fn, their device ms per call),
    read from torch.profiler; up to three profiles, as a profile taken
    after others has come back empty (PERF.md section 7)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.key == "aten::_int_mm"]
        if rows and rows[0].device_time_total > 0:
            return rows[0].count / n, rows[0].device_time_total / n / 1e3
    return (rows[0].count / n if rows else 0.0), 0.0


def int_mm_rules(dev):
    """What torch._int_mm takes on this card, probed on small int8
    operands: rows, depth and width against its rules of more than 16
    rows and multiples of 8, and the four operand layouts. The layout
    the port uses (a row-major, b column-major, 17+ rows, 8-multiples)
    must work and give the plain sums."""
    gen = torch.Generator().manual_seed(SEED)

    def codes(r, c):
        return torch.randint(-127, 128, (r, c), generator=gen,
                             dtype=torch.int8)

    def run(m, k, n, a_cols=False, b_cols=True):
        a, b = codes(m, k), codes(k, n)
        a_d = (a.t().contiguous().to(dev).t() if a_cols
               else a.to(dev))
        b_d = b.t().contiguous().to(dev).t() if b_cols else b.to(dev)
        try:
            got = torch._int_mm(a_d, b_d).cpu()
        except RuntimeError as e:
            return "refused: " + str(e).splitlines()[0][:90]
        return ("ok" if torch.equal(got, torch.mm(a.int(), b.int()))
                else "wrong sums")

    rules = {"M=17, K=32, N=32 (a row-major, b column-major)":
             run(17, 32, 32), "M=16": run(16, 32, 32), "M=1": run(1, 32, 32),
             "K=36": run(32, 36, 32), "N=36": run(32, 32, 36),
             "a row-major, b row-major": run(32, 32, 32, b_cols=False),
             "a column-major, b column-major": run(32, 32, 32, a_cols=True),
             "a column-major, b row-major": run(32, 32, 32, a_cols=True,
                                                b_cols=False)}
    print("torch._int_mm on this card: " + json.dumps(rules), flush=True)
    require(rules["M=17, K=32, N=32 (a row-major, b column-major)"] == "ok",
            "torch._int_mm refuses the port's layout")


def check_int8_products(dev, smi, q8, bf16, gen):
    """Phase 16: at B = 16 and 256, the seven int8 products of one
    forward of the int8 server's model: the card's int32 sums equal the
    CPU plain version's bit for bit; _int_mm launched 7 times per
    forward (profile); timings of each product beside the bf16 product
    of the same shape, of the activation quantization alone and of the
    padded _int_mm alone, and of the whole forward in bf16 and int8."""
    report = {}
    for b in (SERVE_B, 256):
        batch = [x.to(dev) for x in random_batch(b, q8.cfg, gen)]
        calls = []
        with recording_int8(calls), torch.inference_mode():
            q8(*batch)
        torch.cuda.synchronize()
        require(len(calls) == len(INT8_PRODUCTS),
                f"{len(calls)} int8 products per forward, want 7")
        rows = {}
        for name, c in zip(INT8_PRODUCTS, calls):
            plain = quant.int8_sums(c["x_q"].cpu(), c["w_q"].cpu())
            require(torch.equal(c["acc"].cpu(), plain),
                    f"B={b} {name}: the card's int32 sums differ from the "
                    f"CPU plain version's")
            x, w_q, w_scale = c["x"], c["w_q"], c["w_scale"]
            m, k = x.shape
            n = w_scale.shape[0]
            w16 = torch.randn(n, k, generator=gen).to(
                dev, torch.bfloat16).t()
            out = torch.bfloat16 if "convolution" in name else torch.float32
            x_q = c["x_q"]
            rows[name] = {
                "shape": [m, k, n],
                "int8_ms": time_device_ms(
                    lambda: quant.int8_matmul(x, w_q, w_scale), 20, 5),
                "bf16_matmul_ms": time_device_ms(
                    lambda: matmul(x.to(torch.bfloat16), w16, out), 20, 5),
                "activation_quant_ms": time_device_ms(
                    lambda: quant.quantize_activation(x), 20, 5),
                "padded_int_mm_ms": time_device_ms(
                    lambda: quant.padded_int_mm(x_q, w_q), 20, 5)}

        def fwd(model):
            def run():
                with torch.inference_mode():
                    model(*batch)
            return run

        count, int_mm_ms = int_mm_profile(fwd(q8))
        require(count == len(INT8_PRODUCTS),
                f"the profile shows {count} aten::_int_mm per forward")
        with torch.inference_mode():
            l8, l16 = q8(*batch)[0].float(), bf16(*batch)[0].float()
        rel = float((l8 - l16).abs().max() / l16.abs().max())
        agree = float((l8.argmax(-1) == l16.argmax(-1)).float().mean())
        print(f"B={b}, random batch: int8 logits within {rel:.3e} of the "
              f"bf16 logits' largest magnitude (< {INT8_LOGIT_TOL}), top-1 "
              f"agreement {agree:.4f}", flush=True)
        require(rel < INT8_LOGIT_TOL, f"int8 logits {rel} off bf16's")
        report[f"B={b}"] = {
            "forward_bf16_ms": time_device_ms(fwd(bf16), 20, 5),
            "forward_int8_ms": time_device_ms(fwd(q8), 20, 5),
            "int_mm_per_forward": count,
            "int_mm_device_ms_per_forward": int_mm_ms, "products": rows}
        print(f"int8 products at B={b}: the card's int32 sums equal the CPU "
              f"plain version's bit for bit at all seven "
              f"({', '.join(INT8_PRODUCTS)}); torch.profiler reads {count:g} "
              f"aten::_int_mm per forward, {int_mm_ms:.4f} device ms",
              flush=True)
    print(f"int8 serving timing ({smi}; device ms, launches queued behind a "
          f"sleep kernel; bf16_matmul_ms = the bf16 product of the same "
          f"shape as the float model runs it, random weights; "
          f"activation_quant_ms = absmax, divide, round, clip and cast "
          f"alone; padded_int_mm_ms = the padding of the codes and "
          f"_int_mm alone): " + json.dumps(report), flush=True)


def serve_main_process(smi, path, image_ids):
    """``python -m vqa_project_tpu_torch.cli.serve --quantize --port 0``
    from the msgpack in a process of its own: it prints its address and
    answers /healthz and 16 requests; then it is stopped."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "vqa_project_tpu_torch.cli.serve", *CLI_DATA,
         "--bsize", str(SERVE_B), "--model_path", path, "--quantize",
         "--port", "0"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env)
    watchdog = threading.Timer(600, proc.kill)
    watchdog.start()
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving on "):
                break
        require(lines and lines[-1].startswith("serving on "),
                "cli.serve exited before serving: " + "".join(lines[-20:]))
        start_s = time.perf_counter() - t0
        host, port = lines[-1].split()[2][len("http://"):].split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=120)
        answers = []
        for i in range(16):
            conn.request("POST", "/predict", body=json.dumps(
                {"question": "what color is the thing ?",
                 "image_id": image_ids[i]}))
            resp = conn.getresponse()
            body = json.loads(resp.read())
            require(resp.status == 200, f"cli.serve answered {body}")
            answers.append(body["answer"])
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        watchdog.cancel()
        proc.kill()
        proc.wait(timeout=60)
        proc.stdout.close()
    require(health["requests_served"] == 16, f"/healthz {health}")
    print(f"python -m vqa_project_tpu_torch.cli.serve --quantize --port 0 "
          f"(its own process, {smi}): serving after {start_s:.1f} s, "
          f"16 answers ({len(set(answers))} distinct), /healthz {health}; "
          f"stopped", flush=True)


# phase 15's trained checkpoint (epoch 2) and phase 16's copies of it
TRAINED_CKPT = os.path.join("run", "model_2.ckpt")
MSGPACK_CKPT = "jax.ckpt"
EXPORTED_PT = "ref.pt"


def write_trained_msgpack(dev, val):
    """Phase 15's trained checkpoint with its Adam state written again as
    a JAX msgpack (MSGPACK_CKPT); returns (model, optimizer, scheduler,
    payload) as loaded from the trained checkpoint."""
    mcfg, tcfg = cli.make_configs(cli.input_args(CLI_DATA)[0])
    model = build_model(mcfg, val, device=dev)
    optimizer, scheduler = make_optimizer(model, tcfg, cli_sizes()[0])
    payload = load_checkpoint(TRAINED_CKPT, model, optimizer, scheduler)
    write_jax_checkpoint(MSGPACK_CKPT, model, optimizer,
                         step=payload["step"], epoch=payload["epoch"],
                         extra=payload["extra"])
    return model, optimizer, scheduler, payload


def serving_from_files(dev, smi, sdir):
    """Phase 16, the main path: the serving CLI from phase 15's files.

    Phase 15's trained checkpoint (epoch 2) is written again as a JAX
    msgpack with its Adam state (``write_jax_checkpoint``) and read back
    bit for bit; ``cli.serve.build_server`` serves it over HTTP in bf16
    and with ``--quantize`` at B = 16 and 256 (every bf16 answer equal
    to a direct forward's top-1, int8 top-1 agreeing with bf16 on >= 90%,
    A 2 and B 1 per served batch); the exported reference .pt and the
    port's checkpoint serve the same; ``main`` serves in a process of its
    own; the int8 products are held to the CPU plain version; the export
    reloads bit for bit and ``cli.validate_parity`` prints evaluate()'s
    accuracy."""
    t_phase = time.perf_counter()
    args, _, _ = cli.input_args(CLI_DATA)
    mcfg, tcfg = cli.make_configs(args)
    val = GraphVQADataset.vqa2(sdir, "val")
    trained = TRAINED_CKPT
    msgpack_path = MSGPACK_CKPT
    model, optimizer, scheduler, payload = write_trained_msgpack(dev, val)
    fresh = build_model(mcfg, val, device=dev)
    opt2, sched2 = make_optimizer(fresh, tcfg, cli_sizes()[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back = load_checkpoint(msgpack_path, fresh, opt2, sched2)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    names = dict(fresh.named_parameters())
    require(all(torch.equal(v, fresh.state_dict()[k])
                for k, v in model.state_dict().items())
            and back["step"] == payload["step"]
            and back["extra"] == payload["extra"]
            and sched2.last_epoch == scheduler.last_epoch
            and all(torch.equal(optimizer.state[p][m],
                                opt2.state[names[k]][m])
                    for k, p in model.named_parameters()
                    for m in ("exp_avg", "exp_avg_sq")),
            "the msgpack checkpoint does not read back to the trained "
            "weights and Adam state")
    size = os.path.getsize(msgpack_path)
    print(f"phase 15's epoch-2 checkpoint written as a JAX msgpack "
          f"({size / 1e6:.1f} MB: weights, Adam's moments, step "
          f"{payload['step']}); load_checkpoint read it back (weights, "
          f"moments, step, scheduler bit for bit) in {load_s:.3f} s "
          f"({smi})", flush=True)

    jobs = serving_jobs([w for w in val.q_wtoi if w], list(
        val.store.id_to_row), SERVE_JOBS, SEED + 16)
    latency = {}
    answers = {}
    for b in (SERVE_B, 256):
        bf16, answers[("bf16", b)], *latency[("bf16", b)] = serve_from(
            f"bf16 serving from the msgpack at B={b}", msgpack_path, b,
            jobs, smi)
        want = direct_top1(bf16, val, jobs, dev, b)
        require(answers[("bf16", b)] == want, f"B={b}: served answers "
                "differ from a direct forward's top-1")
        q8, answers[("int8", b)], *latency[("int8", b)] = serve_from(
            f"int8 serving (--quantize) from the msgpack at B={b}",
            msgpack_path, b, jobs, smi, "--quantize")
        agree = float(np.mean([g == w for g, w in zip(
            answers[("int8", b)], answers[("bf16", b)])]))
        print(f"B={b}: bf16 answers equal a direct forward's top-1 "
              f"({len(jobs)}/{len(jobs)}); int8 top-1 agrees with bf16 on "
              f"{agree:.4f} (>= {INT8_AGREEMENT})", flush=True)
        require(agree >= INT8_AGREEMENT, f"int8 agreement {agree} at B={b}")

    pt_path = EXPORTED_PT
    export_cli.main([msgpack_path, pt_path])
    exported = load_reference_checkpoint(pt_path)
    require(all(torch.equal(v.cpu(), exported[k])
                for k, v in model.state_dict().items())
            and set(exported) == set(model.state_dict()),
            "the exported .pt does not hold the written weights")
    print("cli.export_torch of the msgpack: the .pt reads back through "
          "load_reference_checkpoint to the written weights bit for bit",
          flush=True)
    for kind, path in (("reference .pt", pt_path),
                       ("port checkpoint", trained)):
        _, got, _, _ = serve_from(f"bf16 serving from the {kind} at "
                                  f"B={SERVE_B}", path, SERVE_B, jobs, smi)
        require(got == answers[("bf16", SERVE_B)],
                f"the {kind} serves other answers than the msgpack")
        q8_kind, _, _, _ = serve_from(
            f"int8 serving from the {kind} at B={SERVE_B}", path, SERVE_B,
            jobs, smi, "--quantize")
        q8_sd = q8_kind.state_dict()
        require(all(torch.equal(v, q8_sd[k])
                    for k, v in q8.state_dict().items()),
                f"the {kind}'s int8 weights differ from the msgpack's")
        print(f"the {kind} serves the msgpack's bf16 answers and int8 "
              f"weights bit for bit", flush=True)
    serve_main_process(smi, msgpack_path, list(val.store.id_to_row))
    int_mm_rules(dev)
    check_int8_products(dev, smi, q8, bf16,
                        torch.Generator().manual_seed(SEED + 16))

    out = _Tee()
    with contextlib.redirect_stdout(out):
        parity_cli.main([
            "--model_path", pt_path, "--data_dir", sdir, "--split", "val",
            "--emb", str(args.emb), "--hid", str(args.hid), "--n_kernels",
            str(args.n_kernels), "--neighbourhood_size",
            str(args.neighbourhood_size), "--n_obj", str(args.n_obj),
            "--device", str(dev)])
    printed = json.loads(out.getvalue()[out.getvalue().index("{"):])
    acc, _, _ = evaluate(model, val, TRAIN_B, result_path=None, device=dev)
    require(printed["vqa_accuracy_pct"] == round(acc, 2)
            and printed["n_questions"] == val.n_questions,
            f"validate_parity printed {printed}, evaluate() gives {acc}")
    print(f"cli.validate_parity on the .pt: accuracy "
          f"{printed['vqa_accuracy_pct']} % equal to evaluate()'s "
          f"{acc:.4f} on val", flush=True)
    print(f"phase 16 in {time.perf_counter() - t_phase:.1f} s ({smi}): "
          + json.dumps({
              "msgpack_mb": size / 1e6, "msgpack_load_s": load_s,
              "serving_ms_p50_p99": {f"{k[0]} B={k[1]}": v
                                     for k, v in latency.items()}}),
          flush=True)


# ---------------- the medical grid search from files ----------------

MED_B = 8            # the medical harness's --bsize
MED_K = 51           # its --n_obj
MED_DROPOUT = 0.4    # its --dropout
# the grid's corner cells (n_kernels, neighbourhood) of cli/medical.py's
# lists n in {4, 8, 16, 32} and m in {16, ..., 36}, and the two
# convolutions' widths n * d at hid 1024: conv1 (alpha, dropout in
# training) 2048, conv2 (the 0/1 mask) 1024. n = 4 gives conv1 d = 512,
# past kernels A and C's 256-column tile; n = 32 gives conv2 d = 32,
# half of kernel D's 64-column chunk
MED_CORNERS = [(n, m) for n in (4, 32) for m in (16, 36)]
MED_WIDTHS = ((2048, True), (1024, False))
# `--synthetic` at full medical width: 256 images of 51 x 2048 f32 (one
# json, train = val: 2048 questions, 256 steps and 256 eval batches of 8
# a cell), 3000 answers, 12k question words; hid 1024, emb 300, bf16
MED_COMMON = ["--data_dir", "data", "--synthetic", "--synthetic_feat_dim",
              "2048", "--synthetic_answers", "3000", "--synthetic_vocab",
              "12000", "--hid", "1024", "--emb", "300", "--bsize",
              str(MED_B), "--dropout", str(MED_DROPOUT), "--lr", "1e-3",
              "--compute_dtype", "bfloat16", "--ep", "1", "--num_devices",
              "1"]
CLEF_ARGS = [*MED_COMMON, "--synthetic_images", "256",
             "--synthetic_questions", "2048", "--neighbors_list", "16", "36",
             "--kernels_list", "4", "32"]
# MIMIC's preset cell under --fast_math; 1020 questions a split, so that
# the last eval batch holds 4 questions and 4 padding rows
MIMIC_ARGS = [*MED_COMMON, "--synthetic_images", "128",
              "--synthetic_questions", "1020", "--neighbors_list", "19",
              "--kernels_list", "8", "--fast_math"]


def medical_corner_shapes():
    return [(MED_B, MED_K, m, n, nd // n, use_alpha,
             f"medical n={n} m={m} conv{1 if use_alpha else 2}")
            for n, m in MED_CORNERS for nd, use_alpha in MED_WIDTHS]


def check_medical_corners(dev, gen, errs):
    """Phase 17 (a): kernels A, C and D at the grid's corner shapes
    against their plain versions, as phases 3 and 7 hold them (f32 and
    bf16, NaN-filled reruns bit for bit, the hi/lo rounding share with
    its one-pass control, conv1's dropout mask at the medical rate); then
    their bf16 device times beside their bounds. Returns the timings."""
    for shape in medical_corner_shapes():
        check_edge_forward_shape(shape, True, gen, dev, errs)
        check_edge_training_shape(shape, True, gen, dev, errs,
                                  dropout=MED_DROPOUT)
    timings = []
    for n, m in MED_CORNERS:
        convs = []
        for nd, use_alpha in MED_WIDTHS:
            sel, pseudo, proj, gp = edge_inputs(MED_B, MED_K, m, n, nd // n,
                                                use_alpha, gen, dev)
            proj = proj.to(torch.bfloat16)
            rate = MED_DROPOUT if use_alpha else 0.0
            seeds = random_seeds(MED_B, gen, dev) if rate else None
            out, ghat, denom = sel_aggregate_act_residuals(
                sel, pseudo, proj, gp, True, rate, seeds)
            g = torch.randn(proj.shape, generator=gen).to(dev, torch.bfloat16)
            convs.append((sel, pseudo, proj, gp, rate, seeds, out, ghat,
                          denom, g))
        row = {"n": n, "m": m}
        calls = {
            "A": (lambda: [fused_sel_aggregate_act(*c[:4], relu=True)
                           for c in convs],
                  [edge_bound(*c[:4]) for c in convs]),
            "C": (lambda: [sel_aggregate_act_residuals(*c[:4], True, c[4],
                                                       c[5]) for c in convs],
                  [residual_bound(*c[:5])[:2] for c in convs]),
            "D": (lambda: [sel_aggregate_act_vjp(c[9], c[0], c[7], c[8],
                                                 c[1], c[2], c[3], c[6],
                                                 c[4]) for c in convs],
                  [vjp_bound(*c[:4], True) for c in convs])}
        for name, (fn, bounds) in calls.items():
            ms = time_device_ms(fn, samples=30)
            b_ms, by = bound(sum(x[0] for x in bounds),
                             sum(x[1] for x in bounds))
            row[name] = {"ms": ms, "bound_ms": b_ms, "bound_by": by}
        timings.append(row)
    print("medical corners, bf16, B=8, K=51, conv1 + conv2 per call (device "
          "ms; launches queued behind a sleep kernel) beside the bound: "
          + json.dumps(timings), flush=True)
    return timings


class GridProbe:
    """Within: loop.fit, loop.evaluate and loop.make_feature_cache (what
    cli.medical calls) wrapped to read the launch counts before and after
    each call, the card's allocated bytes at each fit's start, the cache
    builds, and the last fit's model, optimizer and cache. The wrapped
    functions run unchanged. Only with ``keep_last`` does the probe hold a
    model past its cell."""

    def __init__(self, keep_last=False):
        self.fits, self.evals, self.builds = [], [], 0
        self.keep_last, self.last = keep_last, None

    def __enter__(self):
        self._real = (train_loop.fit, train_loop.evaluate,
                      train_loop.make_feature_cache)
        real_fit, real_eval, real_cache = self._real

        def fit_(*a, **k):
            start = read_counts()
            mem = torch.cuda.memory_allocated()
            model, optimizer, acc = real_fit(*a, **k)
            torch.cuda.synchronize()
            self.fits.append({"counts": _minus(read_counts(), start),
                              "mem_at_start": mem,
                              "model_bytes": 4 * sum(
                                  p.numel() * 4 for p in model.parameters())})
            if self.keep_last:
                self.last = (model, optimizer, k.get("cache"))
            return model, optimizer, acc

        def eval_(model, ds, batch_size, **k):
            start = read_counts()
            out = real_eval(model, ds, batch_size, **k)
            self.evals.append({"counts": _minus(read_counts(), start),
                               "batches": -(-ds.n_questions // batch_size)})
            return out

        def cache_(*a, **k):
            self.builds += 1
            return real_cache(*a, **k)

        train_loop.fit, train_loop.evaluate = fit_, eval_
        train_loop.make_feature_cache = cache_
        return self

    def __exit__(self, *exc):
        (train_loop.fit, train_loop.evaluate,
         train_loop.make_feature_cache) = self._real
        return False


def _minus(a, b):
    return {k: a[k] - b[k] for k in a}


def medical_main(main_fn, argv, probe):
    """``main_fn(argv)`` (run_imageclef.main or run_mimic.main) in this
    process under ``probe``: (its cells, stdout, wall seconds). The
    counts are set to 0 just before and read by the probe."""
    out = _Tee()
    reset_counts()
    t0 = time.perf_counter()
    with probe, contextlib.redirect_stdout(out):
        cells = main_fn(argv)
    torch.cuda.synchronize()
    return cells, out.getvalue(), time.perf_counter() - t0


def check_cell_launches(label, probe, steps):
    """Per training step the image gather 1, C 2, D 2, B 1, E 1 + 1, A 0
    (phase 11's); per eval batch the image gather 1, A 2, B 1."""
    for i, (f, e) in enumerate(zip(probe.fits, probe.evals)):
        per_step = {k: v / steps for k, v in f["counts"].items()}
        per_batch = {k: v / e["batches"] for k, v in e["counts"].items()}
        want_batch = {k: 0 for k in per_batch}
        want_batch.update(EVAL_BATCH_LAUNCHES)
        require(per_step == CACHE_STEP_LAUNCHES,
                f"{label} cell {i}: launches per train step {per_step}, "
                f"want {CACHE_STEP_LAUNCHES}")
        require(per_batch == want_batch,
                f"{label} cell {i}: launches per eval batch {per_batch}, "
                f"want {want_batch}")
    return per_step, per_batch


def _finite_losses(out):
    losses = [float(x) for x in re.findall(r"ave loss: (\S+),", out)]
    require(losses and all(map(math.isfinite, losses)),
            f"the logged losses {losses}")
    return losses


def profile_medical_steps(dev, ds, cache):
    """Phase 17 (d): a training step of the grid's corner cells at the
    smallest and largest n (the largest m) profiled: the card's busy
    share and the device items per step, each step fed by the image
    gather from ``cache``."""
    image_fn = make_image_fn(cache, "bfloat16", False)
    batches = list(itertools.islice(Batcher(ds, MED_B, shuffle=True,
                                            materialize=False), 12))
    m = max(m for _, m in MED_CORNERS)
    for n in sorted({n for n, _ in MED_CORNERS}):
        args, _, _ = medical_cli.medical_input_args(
            [*CLEF_ARGS, "--n_kernels", str(n), "--neighbourhood_size",
             str(m)])
        mcfg, tcfg = medical_cli.make_configs(args)
        model = build_model(mcfg, ds, device=dev)
        optimizer, scheduler = make_optimizer(model, tcfg, len(batches))
        gen = torch.Generator(device=dev).manual_seed(SEED)
        feed = itertools.cycle(batches)
        profile(lambda: train_step(model, optimizer, scheduler, next(feed),
                                   gen, image_fn),
                f"a medical training step, B={MED_B}, K={MED_K}, n={n}, "
                f"m={m}, bf16, dropout {MED_DROPOUT}")


def imageclef_grid(dev, smi):
    """Phase 17 (b): cli.run_imageclef.main over the 2 x 2 grid corners at
    full medical width: four grid lines, four checkpoints that load back
    through load_checkpoint and answer val as their cell did, the best
    cell's CSV of every val question, one cache build, the launches per
    step and per
    eval batch, finite losses, and the card's allocated memory at each
    cell's start within one model (its weights, gradients and moments)
    of the first cell's."""
    probe = GridProbe()
    cells, out, wall = medical_main(run_imageclef.main, CLEF_ARGS, probe)
    n_q = 2048
    steps = n_q // MED_B
    require(len(cells) == 4 and len(probe.fits) == len(probe.evals) == 4,
            f"{len(cells)} cells")
    per_step, per_batch = check_cell_launches("imageclef", probe, steps)
    losses = _finite_losses(out)
    with open(f"grid_search_nodes_{MED_K}.txt") as f:
        lines = f.read().splitlines()
    require(lines == [f"neighbors: {c.neighbors}, kernels: {c.kernels}, "
                      f"Validation acc: {c.acc:.3f} %" for c in cells],
            f"grid lines {lines}")
    # a CSV at each cell that beats the best so far (the JAX harness's
    # rule), the last the best cell's
    best = 0.0
    want_csvs = []
    for c in cells:
        if c.acc > best:
            best = c.acc
            want_csvs.append(f"clef_{MED_K}_{c.acc:.2f}.csv")
    csvs = sorted(os.listdir("figures"))
    require(want_csvs and csvs == sorted(set(want_csvs)),
            f"CSVs {csvs}, want {want_csvs}")
    with open(os.path.join("figures", want_csvs[-1])) as f:
        rows = f.read().splitlines()
    require(rows[0] == "image_id,question,prediction,answer"
            and len(rows) == 1 + n_q, f"the CSV holds {len(rows)} lines")
    require(probe.builds == 1, f"make_feature_cache ran {probe.builds} times")
    mems = [f["mem_at_start"] for f in probe.fits]
    model_bytes = max(f["model_bytes"] for f in probe.fits)
    require(max(mems) - mems[0] <= model_bytes,
            f"allocated bytes at the cells' starts {mems} grew past one "
            f"model's {model_bytes}")
    # every checkpoint, loaded back, answers val as its cell's model did
    flags, _, _ = medical_cli.medical_input_args(CLEF_ARGS)
    val = GraphVQADataset.imageclef(os.path.join("data",
                                                 "synthetic_imageclef"),
                                    "train", flags.emb, flags.n_obj)
    cache = make_feature_cache(val, TrainConfig(), "bfloat16", dev)
    for cell in cells:
        args, _, _ = medical_cli.medical_input_args(
            [*CLEF_ARGS, "--n_kernels", str(cell.kernels),
             "--neighbourhood_size", str(cell.neighbors)])
        mcfg, _ = medical_cli.make_configs(args)
        model = build_model(mcfg, val, device=dev)
        payload = load_checkpoint(cell.path, model)
        acc, result, _ = evaluate(model, val, MED_B, result_path=None,
                                  cache=cache, device=dev)
        require(payload["step"] == steps and acc == cell.acc
                and result == cell.result,
                f"{cell.path} answers otherwise than its cell")
        del model
    profile_medical_steps(dev, val, cache)
    del cache
    report = [{"neighbors": c.neighbors, "kernels": c.kernels,
               "val_acc": c.acc, "step_p50_ms": c.step_times["p50_ms"],
               "qa_pairs_per_sec_per_chip":
                   c.step_times["qa_pairs_per_sec_per_chip"],
               "eval_questions_per_s": c.eval_questions_per_s}
              for c in cells]
    print(f"imageclef grid ({smi}): 4 cells in {wall:.3f} s, {steps} steps "
          f"and {n_q // MED_B} eval batches each, losses "
          f"{losses[0]:.5f} .. {losses[-1]:.5f} all finite; launches per "
          f"train step {per_step}, per eval batch {per_batch}; one cache "
          f"build; allocated bytes at each cell's start {mems} (one model "
          f"{model_bytes}); the four checkpoints answer val as their cells "
          f"did; cells (StepTimer over steps 4-{steps}, each ending in a "
          f"sync; evaluate on the host clock): " + json.dumps(report),
          flush=True)
    return report, per_step, per_batch


def mimic_fast_math(dev, smi):
    """Phase 17 (c): cli.run_mimic.main, the preset cell under
    --fast_math with its own train and val stores: two cache builds,
    the launches, finite losses, every stored Adam moment bfloat16; the
    trained model and optimizer saved by async_save_checkpoint read back
    equal to a synchronous save; and (d) a profiling.trace of two
    training steps holding their annotate names."""
    probe = GridProbe(keep_last=True)
    cells, out, wall = medical_main(run_mimic.main, MIMIC_ARGS, probe)
    (cell,) = cells
    steps = 1020 // MED_B
    per_step, per_batch = check_cell_launches("mimic", probe, steps)
    losses = _finite_losses(out)
    require(probe.builds == 2, f"make_feature_cache ran {probe.builds} times "
            "(want train's and val's)")
    model, optimizer, cache = probe.last
    stored = torch.load(cell.path, map_location="cpu", weights_only=True)
    moments = [v for st in stored["optimizer"]["state"].values()
               for k, v in st.items() if k.startswith("exp_avg")]
    live = [v for st in optimizer.state.values()
            for k, v in st.items() if k.startswith("exp_avg")]
    require(moments and len(moments) == len(live)
            and all(m.dtype == torch.bfloat16 for m in moments + live),
            "an Adam moment is not bfloat16 under --fast_math")
    t0 = time.perf_counter()
    async_save_checkpoint("async.pt", model, optimizer, step=steps, epoch=1)
    enqueue_s = time.perf_counter() - t0
    save_checkpoint("sync.pt", model, optimizer, step=steps, epoch=1)
    wait_for_async_saves()
    a = torch.load("async.pt", map_location="cpu", weights_only=True)
    b = torch.load("sync.pt", map_location="cpu", weights_only=True)
    same = (a.keys() == b.keys()
            and all(torch.equal(v, b["state_dict"][k])
                    for k, v in a["state_dict"].items())
            and all(torch.equal(v, stored["state_dict"][k])
                    for k, v in a["state_dict"].items())
            and all(a["optimizer"]["state"][i][k].dtype
                    == b["optimizer"]["state"][i][k].dtype
                    and torch.equal(a["optimizer"]["state"][i][k],
                                    b["optimizer"]["state"][i][k])
                    for i in b["optimizer"]["state"]
                    for k in b["optimizer"]["state"][i]))
    require(same, "the asynchronous save differs from the synchronous one")
    # (d) two traced training steps, annotated
    flags, _, _ = medical_cli.medical_input_args(MIMIC_ARGS)
    train_ds = GraphVQADataset.mimic(os.path.join("data", "synthetic_mimic"),
                                     "train", flags.emb, flags.n_obj)
    batches = iter(Batcher(train_ds, MED_B, materialize=False))
    image_fn = make_image_fn(cache, "bfloat16", False)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    names = [f"medical_train_step_{i}" for i in range(2)]
    with profiling.trace("trace") as prof:
        for name in names:
            with profiling.annotate(name):
                m = train_step(model, optimizer, None, next(batches), gen,
                               image_fn)
                profiling.force_sync(m["loss"])
    events = prof.key_averages()
    seen = {e.key for e in events}
    kernels = sum(1 for e in events
                  if getattr(e, "device_time_total", 0) > 0)
    files = [f for f in os.listdir("trace") if f.endswith(".pt.trace.json")]
    require(set(names) <= seen and len(files) == 1,
            f"the trace's names {sorted(seen)[:20]}..., files {files}")
    print(f"mimic --fast_math ({smi}): the preset cell (m=19, n=8) in "
          f"{wall:.3f} s, {steps} steps, {-(-1020 // MED_B)} eval batches (the "
          f"last 4 questions and 4 padding rows), losses {losses[0]:.5f} .. "
          f"{losses[-1]:.5f} all finite; launches per train step "
          f"{per_step}, per eval batch {per_batch}; two cache builds; "
          f"{len(moments)} Adam moments, all bfloat16; async_save_checkpoint "
          f"returned in {enqueue_s:.3f} s and reads back equal to "
          f"save_checkpoint; cell: " + json.dumps({
              "val_acc": cell.acc, "step_p50_ms": cell.step_times["p50_ms"],
              "qa_pairs_per_sec_per_chip":
                  cell.step_times["qa_pairs_per_sec_per_chip"],
              "eval_questions_per_s": cell.eval_questions_per_s}), flush=True)
    print(f"profiling.trace of two training steps: {files[0]} "
          f"({os.path.getsize(os.path.join('trace', files[0]))} bytes) holds "
          f"{names}; {kernels} events with device time", flush=True)
    return cell


def medical_grid_search(dev, gen, smi, errs):
    """Phase 17, the main path: the medical grid search from files, in
    the working directory (a temporary one)."""
    t_phase = time.perf_counter()
    timings = check_medical_corners(dev, gen, errs)
    report, per_step, per_batch = imageclef_grid(dev, smi)
    mimic = mimic_fast_math(dev, smi)
    phase_s = time.perf_counter() - t_phase
    print(f"phase 17 in {phase_s:.1f} s ({smi}): " + json.dumps({
        "imageclef_cells": report, "mimic_step_p50_ms":
        mimic.step_times["p50_ms"], "mimic_eval_questions_per_s":
        mimic.eval_questions_per_s, "launches_per_train_step": per_step,
        "launches_per_eval_batch": per_batch, "corners": timings}),
        flush=True)


# ---------------- the interpretability plots from files ----------------

PLOT_B, PLOT_BATCHES = 32, 4     # cli.plot's --bsize and --n_batches
PLOT_QUESTIONS = 8               # given_question_graph at B = 1
PLOT_TOP = 7                     # cli.plot's --top_nodes
# one sweep batch: the image gather, A in both convolutions, B (as
# --eval's); one given question at B = 1 from the host store: A 2, B 1
# and no gather
QUESTION_LAUNCHES = SERVE_BATCH_LAUNCHES
# the card's f32 sweep against the CPU's: adjacency within 1e-4 x max|A|,
# top-1 agreeing on >= 99% of rows, the top-7 node sets equal on >= 95%
PLOT_ADJ_TOL, PLOT_TOP1, PLOT_TOP_NODES = 1e-4, 0.99, 0.95
# the bf16 given-question forward's answer equal to the sweep's on >= 7
PLOT_QUESTION_AGREE = 7


def plot_model_flags():
    """CLI_DATA's model flags as cli.plot takes them (its defaults at
    full width)."""
    args = cli.input_args(CLI_DATA)[0]
    return ["--emb", str(args.emb), "--hid", str(args.hid), "--n_kernels",
            str(args.n_kernels), "--neighbourhood_size",
            str(args.neighbourhood_size), "--n_obj", str(args.n_obj)]


def plot_model(dev, val, path, compute_dtype):
    """The model cli.plot builds for CLI_DATA's flags on ``dev`` in
    ``compute_dtype``, holding the checkpoint at ``path`` (any kind
    load_checkpoint reads)."""
    args = plot_cli.input_args(["--model_path", path, *plot_model_flags(),
                                "--compute_dtype", compute_dtype])
    mcfg = ModelConfig(
        emb_dim=args.emb, hid_dim=args.hid, n_kernels=args.n_kernels,
        neighbourhood_size=args.neighbourhood_size, n_obj=args.n_obj,
        dropout=args.dropout, compute_dtype=args.compute_dtype)
    model = build_model(mcfg, val, device=dev)
    load_checkpoint(path, model)
    return model


def plot_checkpoints(dev, val):
    """{kind: path} of the three checkpoints of phase 15's trained model
    that phase 16 wrote, written again where they are gone."""
    if not os.path.exists(MSGPACK_CKPT):
        write_trained_msgpack(dev, val)
    if not os.path.exists(EXPORTED_PT):
        export_cli.main([MSGPACK_CKPT, EXPORTED_PT])
    return {"port .ckpt": TRAINED_CKPT, "reference .pt": EXPORTED_PT,
            "JAX msgpack": MSGPACK_CKPT}


def top_nodes(adjacency):
    """Each row's top-7 node set, as the renderer ranks nodes."""
    return [frozenset(np.argsort(w)[::-1][:PLOT_TOP].tolist()) for w in
            viz.node_weights_from_adjacency(adjacency)]


def sweep(model, val, out):
    """collect_graphs at cli.plot's batch and batch count: (graphs,
    launch counts, wall s); the counts are set to 0 just before and
    read just after."""
    dev = next(model.parameters()).device
    reset_counts()
    t0 = time.perf_counter()
    graphs = viz.collect_graphs(model, val, out, batch_size=PLOT_B,
                                n_batches=PLOT_BATCHES)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return graphs, read_counts(), time.perf_counter() - t0


def check_sweep_files(out, graphs, val, result):
    """The sweep's files: the CSV rows are evaluate()'s answers for the
    same questions, the npz 128 (36, 36) f32 adjacencies and the index,
    summary.json JAX's keys."""
    answers = {r["question_id"]: r["answer"] for r in result}
    want = [{"image_id": str(val.vqa[i]["image_id"]),
             "question": val.vqa[i]["question"],
             "prediction": answers[int(val.vqa[i]["question_id"])],
             "answer": val.vqa[i].get("answer", "")} for i in graphs.index]
    with open(os.path.join(out, "infer_predictions.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    n = PLOT_B * PLOT_BATCHES
    require(rows == want and graphs.rows == want and len(rows) == n,
            "the sweep's predictions differ from evaluate()'s result rows")
    npz = viz.read_adj(os.path.join(out, "adjacencies.npz"))
    require(sorted(npz) == ["adjacency", "index"]
            and npz["adjacency"].shape == (n, FULL["n_obj"], FULL["n_obj"])
            and npz["adjacency"].dtype == np.float32
            and np.array_equal(npz["index"], np.arange(n))
            and np.array_equal(npz["adjacency"], graphs.adjacency)
            and np.isfinite(npz["adjacency"]).all(),
            "adjacencies.npz holds "
            + str({k: (v.shape, v.dtype) for k, v in npz.items()}))
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    require(sorted(summary) == ["accuracy", "eval_batches", "figures"]
            and summary["figures"] == n
            and summary["eval_batches"] == PLOT_BATCHES,
            f"summary.json {summary}")


def plot_sweeps(dev, smi, val, kinds):
    """Phase 18, the sweep: collect_graphs on the card in bf16 from each
    checkpoint kind (launches per batch the image gather 1, A 2, B 1;
    the files as evaluate() answers; the adjacencies of the three equal
    bit for bit). Returns (the bf16 graphs, the first sweep's wall s,
    the device half's questions/s)."""
    want = {k: 0 for k in WRAPPERS}
    want.update({k: PLOT_BATCHES * v for k, v in EVAL_BATCH_LAUNCHES.items()})
    graphs, walls, result = {}, {}, None
    for kind, path in kinds.items():
        model = plot_model(dev, val, path, "bfloat16")
        out = os.path.join("figures", kind.replace(" ", "_"))
        graphs[kind], counts, walls[kind] = sweep(model, val, out)
        require(counts == want, f"the sweep from the {kind} launched "
                f"{counts}, want {want}")
        if result is None:     # the kinds' rows are held equal below
            _, result, _ = evaluate(model, val, PLOT_B, result_path=None,
                                    max_batches=PLOT_BATCHES, device=dev)
        check_sweep_files(out, graphs[kind], val, result)
    first = graphs["port .ckpt"]
    require(all(np.array_equal(g.adjacency, first.adjacency)
                and g.rows == first.rows for g in graphs.values()),
            "the three checkpoint kinds' sweeps differ")
    # the device half alone: the cache built, evaluate with the
    # adjacencies collected, after a warm-up
    cache = make_feature_cache(val, TrainConfig(batch_size=PLOT_B),
                               model.cfg.compute_dtype, dev)
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate(model, val, PLOT_B, result_path=None,
                 collect_adjacency=True, max_batches=PLOT_BATCHES,
                 cache=cache, device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    qps = PLOT_B * PLOT_BATCHES / statistics.median(times[1:])
    print(f"collect_graphs in bf16 from the {', '.join(kinds)} ({smi}): "
          f"{PLOT_BATCHES} batches of {PLOT_B}, per batch the image gather "
          f"1, A 2, B 1 ({counts}); predictions equal to evaluate()'s "
          f"rows, the three adjacencies equal bit for bit; end to end "
          f"(cache build included) {walls['port .ckpt']:.3f} s, "
          f"{walls['reference .pt']:.3f} s, {walls['JAX msgpack']:.3f} s; "
          f"the device half (evaluate with the adjacencies, cache built) "
          f"{qps:.1f} questions/s, median of 3 after a warm-up (host "
          f"clock)", flush=True)
    return first, walls["port .ckpt"], qps


def card_against_cpu(dev, smi, val):
    """Phase 18, card against CPU: the same sweep in f32 on the card and
    on the CPU with the same weights. Returns the two models."""
    card = plot_model(dev, val, TRAINED_CKPT, "float32")
    t0 = time.perf_counter()
    cpu = plot_model("cpu", val, TRAINED_CKPT, "float32")
    build_s = time.perf_counter() - t0
    got, _, card_s = sweep(card, val, os.path.join("figures", "f32_card"))
    want, _, cpu_s = sweep(cpu, val, os.path.join("figures", "f32_cpu"))
    require(np.array_equal(got.index, want.index), "the sweeps' rows")
    err = norm_err(torch.from_numpy(got.adjacency),
                   torch.from_numpy(want.adjacency))
    top1 = float(np.mean([a["prediction"] == b["prediction"]
                          for a, b in zip(got.rows, want.rows)]))
    nodes = float(np.mean([a == b for a, b in zip(
        top_nodes(got.adjacency), top_nodes(want.adjacency))]))
    print(f"f32 sweep, card against CPU ({smi}): adjacency max abs "
          f"difference {err:.3e} x max|A| (<= {PLOT_ADJ_TOL}); top-1 "
          f"agreement {top1:.4f} (>= {PLOT_TOP1}); top-{PLOT_TOP} node sets "
          f"equal on {nodes:.4f} of rows (>= {PLOT_TOP_NODES}); the sweep "
          f"{card_s:.3f} s on the card, {cpu_s:.3f} s on the CPU (its model "
          f"built and loaded in {build_s:.3f} s)", flush=True)
    require(err <= PLOT_ADJ_TOL and top1 >= PLOT_TOP1
            and nodes >= PLOT_TOP_NODES, "the card's f32 sweep differs from "
            "the CPU's")
    return card, cpu


def given_questions(dev, smi, val, bf16_graphs, card32, cpu32):
    """Phase 18, given_question_graph at B = 1 from the host store for
    the set's first 8 val questions: in bf16 A 2, B 1 and no gather per
    question, the answer equal to the sweep's on >= 7; in f32 the
    adjacency held against the CPU as the sweep's. Returns (wall p50 ms,
    device ms) of the bf16 forward."""
    model = plot_model(dev, val, TRAINED_CKPT, "bfloat16")
    sweep_pred = {int(i): r["prediction"]
                  for i, r in zip(bf16_graphs.index, bf16_graphs.rows)}
    rows = [val.vqa[i] for i in range(PLOT_QUESTIONS)]
    viz.given_question_graph(model, val, rows[0]["question"],
                             rows[0]["image_id"])            # warm-up
    torch.cuda.synchronize()
    wall, agree = [], 0
    reset_counts()
    for row in rows:
        t0 = time.perf_counter()
        g = viz.given_question_graph(model, val, row["question"],
                                     row["image_id"])
        wall.append((time.perf_counter() - t0) * 1e3)
        agree += g.prediction == sweep_pred[g.index]
    counts = read_counts()
    first_index = viz.find_question(val.vqa, rows[0]["question"],
                                    rows[0]["image_id"])
    want = {k: 0 for k in WRAPPERS}
    want.update({k: PLOT_QUESTIONS * v
                 for k, v in QUESTION_LAUNCHES.items()})
    require(counts == want, f"{PLOT_QUESTIONS} given questions launched "
            f"{counts}, want {want}")
    require(agree >= PLOT_QUESTION_AGREE, f"the B = 1 answers equal the "
            f"sweep's for {agree} of {PLOT_QUESTIONS}")
    errs = []
    for row in rows:
        got = viz.given_question_graph(card32, val, row["question"],
                                       row["image_id"])
        want_g = viz.given_question_graph(cpu32, val, row["question"],
                                          row["image_id"])
        errs.append(norm_err(torch.from_numpy(got.adjacency),
                             torch.from_numpy(want_g.adjacency)))
        require(np.isfinite(got.adjacency).all()
                and got.adjacency.shape == (FULL["n_obj"], FULL["n_obj"]),
                "a given question's adjacency")
    require(max(errs) <= PLOT_ADJ_TOL, f"B = 1 f32 adjacency, card "
            f"against CPU: {max(errs):.3e} x max|A|")
    idx = first_index
    t = val.table
    inputs = (torch.from_numpy(t.tokens[idx:idx + 1]).to(dev),
              torch.from_numpy(val.store.batch(t.image_row[idx:idx + 1]))
              .to(dev),
              torch.from_numpy(t.qlen[idx:idx + 1]).to(dev))
    device_ms, items, syncs = busy_and_syncs(lambda: model(*inputs))
    events_ms = time_ms(lambda: model(*inputs), samples=20, reps=5)
    p50 = statistics.median(wall)
    print(f"given_question_graph at B = 1 from the host store ({smi}): "
          f"per question A 2, B 1, no gather ({counts} for "
          f"{PLOT_QUESTIONS}); bf16 answers equal the sweep's for {agree} "
          f"of {PLOT_QUESTIONS}; f32 adjacency card against CPU max "
          f"{max(errs):.3e} x max|A|; bf16 wall p50 {p50:.3f} ms (host "
          f"clock: the lookup, the host rows' copy, the forward, the "
          f"fetch); the forward alone: device busy {device_ms:.4f} ms and "
          f"{items:g} device items a call (torch.profiler), "
          f"{events_ms:.4f} ms a call back to back (CUDA events: the "
          f"larger of the host's enqueue and the device), host "
          f"synchronizations a call {json.dumps(syncs)}", flush=True)
    return p50, device_ms


def busy_and_syncs(fn, n=10):
    """(device busy ms, device items, {host synchronization: count}) per
    call of ``fn`` (torch.profiler: kernels, copies and fills; the CUDA
    runtime's synchronize calls and aten's scalar reads on the host, the
    window's own closing synchronize included as 1 / n)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a profile after others may come back empty
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        device = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        busy = sum(e.self_device_time_total for e in device) / n / 1e3
        if busy > 0:
            break
    syncs = {e.key: e.count / n for e in events
             if "Synchronize" in e.key or e.key in (
                 "aten::_local_scalar_dense", "aten::item")}
    return busy, sum(e.count for e in device) / n, syncs


def render_figures(smi):
    """Phase 18, rendering, where matplotlib is installed: cli.plot.main
    in this process from the trained checkpoint, 128 figures. Returns
    seconds per figure, or None where matplotlib is absent."""
    if importlib.util.find_spec("matplotlib") is None:
        print("figures not rendered: matplotlib is not installed on this "
              "machine (rendering is host work; tests/test_torch_viz.py "
              "holds the figures to the JAX package's on the CPU)",
              flush=True)
        return None
    out = os.path.join("figures", "cli")
    t0 = time.perf_counter()
    plot_cli.main(["--model_path", TRAINED_CKPT, *plot_model_flags(),
                   "--synthetic", "--data_dir", "data", "--plot_dir", out])
    wall = time.perf_counter() - t0
    n = sum(name.endswith(".jpg") for name in os.listdir(out))
    require(n == PLOT_B * PLOT_BATCHES, f"cli.plot rendered {n} figures")
    print(f"cli.plot.main rendered {n} figures in {wall:.3f} s "
          f"({wall / n:.4f} s a figure, the JPEG backfill and the sweep "
          f"included; {smi})", flush=True)
    return wall / n


def tsv_round_trip(smi, sdir):
    """Phase 18, features_to_zarr: phase 15's trainval stores written
    out as a bottom-up-attention TSV (base64 float32) and read back: the
    arrays and the size CSV come back equal. Returns seconds."""
    t0 = time.perf_counter()
    feats = zarr_store.open_group(os.path.join(sdir, "trainval.zarr"))
    boxes = zarr_store.open_group(os.path.join(sdir, "trainval_boxes.zarr"))
    csv_path = os.path.join(sdir, "trainval_image_size.csv")
    sizes = _read_sizes_csv(csv_path)
    tsv = os.path.join("roundtrip", "trainval.tsv")
    os.makedirs("roundtrip")
    with open(tsv, "w") as f:
        for iid, (w, h) in sizes.items():
            b, x = np.asarray(boxes[iid]), np.asarray(feats[iid])
            enc = [base64.b64encode(a.tobytes()).decode("ascii")
                   for a in (b, x)]
            f.write("\t".join([iid, str(int(w)), str(int(h)),
                               str(len(b)), *enc]) + "\n")
    with contextlib.redirect_stdout(io.StringIO()):
        image_features.features_to_zarr("trainval", [tsv], "roundtrip")
    back_f = zarr_store.open_group(os.path.join("roundtrip",
                                                "trainval.zarr"))
    back_b = zarr_store.open_group(os.path.join("roundtrip",
                                                "trainval_boxes.zarr"))
    require(sorted(back_f.keys()) == sorted(feats.keys())
            and all(np.array_equal(np.asarray(back_f[k]),
                                   np.asarray(feats[k]))
                    and np.array_equal(np.asarray(back_b[k]),
                                       np.asarray(boxes[k]))
                    for k in feats.keys()),
            "features_to_zarr did not give the stores back")
    with open(csv_path, "rb") as a, open(os.path.join(
            "roundtrip", "trainval_image_size.csv"), "rb") as b:
        require(a.read() == b.read(), "the size CSV came back otherwise")
    seconds = time.perf_counter() - t0
    print(f"features_to_zarr round trip of phase 15's {len(sizes)}-image "
          f"store ({os.path.getsize(tsv) / 1e6:.1f} MB of TSV): arrays and "
          f"size CSV equal, {seconds:.3f} s ({smi})", flush=True)
    shutil.rmtree("roundtrip")
    return seconds


def plots_from_files(dev, smi, sdir):
    """Phase 18, the main path: the interpretability plots from phase
    15's files and trained checkpoint, in phase 15's working directory."""
    t_phase = time.perf_counter()
    steps = {}

    def step(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        steps[name] = time.perf_counter() - t0
        return out

    val = step("dataset", GraphVQADataset.vqa2, sdir, "val")
    kinds = step("checkpoints", plot_checkpoints, dev, val)
    bf16_graphs, collect_s, qps = step("sweeps", plot_sweeps, dev, smi, val,
                                       kinds)
    card32, cpu32 = step("card_against_cpu", card_against_cpu, dev, smi,
                         val)
    p50, device_ms = step("given_questions", given_questions, dev, smi, val,
                          bf16_graphs, card32, cpu32)
    per_figure = step("render", render_figures, smi)
    tsv_s = step("tsv_round_trip", tsv_round_trip, smi, sdir)
    phase_s = time.perf_counter() - t_phase
    print(f"phase 18 in {phase_s:.1f} s ({smi}): " + json.dumps({
        "sweep_device_questions_per_s": qps, "collect_graphs_s": collect_s,
        "given_question_wall_p50_ms": p50,
        "given_question_forward_busy_ms": device_ms,
        "s_per_figure": per_figure, "tsv_round_trip_s": tsv_s,
        "steps_s": steps}), flush=True)


# ---------------- data parallelism (phase 19) ----------------

# a launch of ranks' hard limit: a hung collective fails the phase, it
# does not hold the script
DP_RANK_TIMEOUT = 240
# (a)'s fits over two ranks on one card
DP_LEGS_A = ("replicated", "sharded", "bf16")
# the model axis of (e) and (c)'s tensor-parallel fits
DP_TP = 2


class LazyTable:
    """A (N, K, F) float32 table whose rows are made when sliced, from
    their index (no host copy of the whole): the VQA v2-size feature
    table that ``ShardedFeatureCache.build`` uploads one chunk at a
    time."""

    def __init__(self, n, k, f):
        self.shape = (n, k, f)
        self.size = n * k * f
        self.dtype = np.dtype(np.float32)

    def __getitem__(self, rows):
        idx = np.arange(*rows.indices(self.shape[0]), dtype=np.float32)
        col = np.arange(self.shape[2], dtype=np.float32)
        base = np.sin(idx[:, None, None] * 0.37 + col[None, None, :] * 0.011)
        return np.broadcast_to(base, (len(idx),) + self.shape[1:])


def params_sha(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_train_cfg(**kw):
    """Phase 19's fits: phase 11's, dropout 0, every step logged."""
    return TrainConfig(lr=1e-4, epochs=1, batch_size=TRAIN_B, log_interval=1,
                       eval_interval=0, seed=SEED, **kw)


def dp_model_cfg():
    return ModelConfig(**{**FULL, "dropout": 0.0})   # bf16


def shard_budget(ds):
    """A per-card budget between half the bf16 table and the whole: the
    sharded cache over two ranks."""
    store = ds["train"].store
    return int(0.75 * (store.features.size * 2 + store.boxes.nbytes))


def shard_partitions(ds, world):
    """The locality partitions of ds["train"]'s questions for a table
    split over ``world`` ranks (``ShardedFeatureCache.partitions``)."""
    n = ds["train"].store.features.shape[0]
    owner = np.arange(n) // -(-n // world)
    return owner[ds["train"].table.image_row].astype(np.int32)


def dp_fit(ds, dev, mesh, train=None, cache=None):
    """fit() of phase 19 on this process (a rank of ``mesh``, or alone
    with mesh None and a prebuilt cache): per-step losses and accuracies
    (on rank 0 or alone), launches per step, median step ms, weights'
    hash. Returns (model, report)."""
    tcfg = dp_train_cfg(**(train or {}))
    world = 1 if mesh is None else mesh.world
    sharded = "device_cache_bytes" in (train or {})
    n_steps = len(Batcher(ds["train"], TRAIN_B, drop_last=True, **(
        {"partitions": shard_partitions(ds, world), "n_partitions": world}
        if sharded else {})))
    kw = {} if cache is None else {"cache": cache}
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = os.path.join(tmp, "metrics.jsonl")
        reset_counts()
        t0 = time.perf_counter()
        model, optimizer, _ = fit(tcfg, dp_model_cfg(), ds["train"],
                                  device=dev, jsonl_path=jsonl, mesh=mesh,
                                  **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        recs = _records(jsonl) if os.path.exists(jsonl) else []
    require(not recs or len(recs) == n_steps, "fit logged other steps")
    report = {
        "losses": [r["loss"] for r in recs],
        "accs": [r["vqa_acc"] for r in recs],
        "step_ms": (statistics.median(1e3 / r["steps_per_sec"]
                                      for r in recs[2:]) if recs else None),
        "per_step": {k: v / n_steps for k, v in counts.items()},
        "sha": params_sha(model), "wall_s": wall}
    if tcfg.tp > 1:
        report["tp"] = tp_report(model, optimizer, mesh)
    return model, report


def tp_report(model, optimizer, mesh, n=20):
    """A tensor-parallel fit's split on this rank: the parameters that
    shard at this width, this rank's Adam moment bytes against a tp = 1
    Adam's, and the median ms (CUDA events, each after a barrier of the
    model group) of the step's all-gather alone and of the whole
    write-back (all-gather and copies into the parameters)."""
    import torch.distributed as dist

    shards = optimizer.shards
    whole_bytes = sum(p.numel() for p in model.parameters()) * (
        torch.empty((), dtype=optimizer.mu_dtype).element_size()
        + torch.empty((), dtype=optimizer.nu_dtype).element_size())
    mine = sum(st[k].numel() * st[k].element_size()
               for st in optimizer.state.values()
               for k in ("exp_avg", "exp_avg_sq"))

    def timed(fn):
        for _ in range(3):
            fn()
        times = []
        for _ in range(n):
            dist.barrier(group=mesh.model_group)
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    return {
        "sharded": shards.names,
        "sharded_params": sum(p.numel() for _, p, _ in shards.sharded),
        "params": sum(p.numel() for p in model.parameters()),
        "moment_bytes_rank": mine, "moment_bytes_whole": whole_bytes,
        "all_gather_bytes": shards.gathered.numel()
        * shards.gathered.element_size(),
        "all_gather_ms": timed(lambda: dist.all_gather_into_tensor(
            shards.gathered, shards.flat, group=mesh.model_group)),
        "write_back_ms": timed(shards.gather)}


def time_all_reduce(numel, dtype, n=20):
    """Median ms of one all_reduce of a flat ``numel`` buffer (CUDA
    events, each launch after a barrier)."""
    import torch.distributed as dist

    buf = torch.ones(numel, dtype=dtype, device="cuda")
    for _ in range(3):
        dist.all_reduce(buf)
    times = []
    for _ in range(n):
        dist.barrier()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        dist.all_reduce(buf)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def busy_share(fn, n=5):
    """(wall ms, device busy ms) per call of fn, from a profile."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / n / 1e3
    return wall, busy


def real_table_steps(dev, mesh, n=10):
    """The VQA v2-size table (123,287 images, bf16) through
    make_feature_cache under the default 8 GiB budget: sharded over the
    ranks; this rank's bytes on the card, and n data-parallel steps on
    locality index batches (each rank's rows from its own shard)."""
    from types import SimpleNamespace

    from vqa_project_tpu_torch.parallel import ShardedFeatureCache

    store = SimpleNamespace(
        features=LazyTable(VQA_IMAGES, 36, FULL["feat_dim"] - 4),
        boxes=np.tile(np.array([0.1, 0.1, 0.6, 0.7], np.float32),
                      (VQA_IMAGES, 36, 1)))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cache = make_feature_cache(SimpleNamespace(store=store), TrainConfig(),
                               "bfloat16", dev, mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    require(isinstance(cache, ShardedFeatureCache),
            f"the VQA v2 table over {mesh.world} cards is not sharded")
    shard_gb = (cache.features.numel() * 2 + cache.boxes.numel() * 4) / 1e9
    cfg = dp_model_cfg()
    model = GraphVQAModel(cfg, device=dev, seed=SEED)
    optimizer, _ = make_optimizer(model, TrainConfig(), 100)
    image_fn = make_image_fn(cache, cfg.compute_dtype)
    rng = np.random.default_rng(SEED + 19)
    per = TRAIN_B // mesh.world
    lo = mesh.rank * cache.shard_size
    hi = min(lo + cache.shard_size, VQA_IMAGES)

    def step():
        # the same global batch on every rank; rank r's rows in its shard
        batch = random_index_batch(TRAIN_B, cfg, VQA_IMAGES, rng)
        for r in range(mesh.world):
            a = r * cache.shard_size
            b = min(a + cache.shard_size, VQA_IMAGES)
            batch["image_row"][r * per:(r + 1) * per] = rng.integers(a, b,
                                                                     per)
        local = {k: v[mesh.rank * per:(mesh.rank + 1) * per]
                 for k, v in batch.items()}
        local["image_row"] = cache.local_rows(local["image_row"])
        float(train_step(model, optimizer, None, local, None, image_fn,
                         mesh=mesh, n_valid=float(batch["mask"].sum()))
              ["loss"])

    ms = median_step_ms(step, n)
    out = {"build_s": build_s, "shard_rows": [lo, hi],
           "shard_gb": shard_gb,
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "step_ms": ms}
    del cache, model, optimizer
    torch.cuda.empty_cache()
    return out


def dp_rank(argv):
    """One rank of phase 19 (``chip_smoke.py --dp-rank <rank> <spec>``):
    joins the spec's process group, runs its legs and writes its report
    beside the spec."""
    rank, spec_path = int(argv[0]), argv[1]
    with open(spec_path) as f:
        spec = json.load(f)
    world = spec["world"]
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(spec["port"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0 if spec["shared"] else rank)
    multihost.maybe_initialize_distributed(dev, spec["backend"])
    mesh = make_mesh(None, dev)
    ds = train_dataset()
    out = {"rank": rank, "world": mesh.world, "backend": mesh.backend}
    for leg in spec["legs"]:
        if leg == "replicated":
            model, out[leg] = dp_fit(ds, dev, mesh)
            if rank == 0:
                torch.save(model.state_dict(), spec["weights"])
        elif leg == "sharded":
            _, out[leg] = dp_fit(ds, dev, mesh, {
                "device_cache_bytes": shard_budget(ds)})
        elif leg == "bf16":
            _, out[leg] = dp_fit(ds, dev, mesh,
                                 {"grad_reduce_dtype": "bfloat16"})
        elif leg == "evaluate":
            model = build_model(dp_model_cfg(), ds["val"], device=dev)
            model.load_state_dict(torch.load(spec["weights"],
                                             weights_only=True))
            path = os.path.join(os.path.dirname(spec_path),
                                f"result_rank{rank}.json")
            reset_counts()
            acc, result, _ = evaluate(model, ds["val"], TRAIN_B,
                                      result_path=path, device=dev,
                                      mesh=mesh)
            out[leg] = {"acc": acc, "n": len(result),
                        "launches": read_counts()}
        elif leg == "all_reduce":
            numel = sum(p.numel() for p in GraphVQAModel(
                dp_model_cfg(), device=dev, seed=SEED).parameters())
            out[leg] = {"numel": numel,
                        "f32_ms": time_all_reduce(numel, torch.float32),
                        "bf16_ms": time_all_reduce(numel, torch.bfloat16)}
        elif leg == "busy":
            cfg = dp_model_cfg()
            model = GraphVQAModel(cfg, device=dev, seed=SEED)
            optimizer, _ = make_optimizer(model, TrainConfig(), 100)
            cache = make_feature_cache(ds["train"], TrainConfig(),
                                       cfg.compute_dtype, dev, mesh)
            image_fn = make_image_fn(cache, cfg.compute_dtype)
            batch = next(iter(Batcher(ds["train"], TRAIN_B, shuffle=True,
                                      seed=SEED, materialize=False)))
            local = pack_index_batch(shard_batch(batch, mesh))

            def step():
                float(train_step(model, optimizer, None, local, None,
                                 image_fn, mesh=mesh,
                                 n_valid=float(batch["mask"].sum()))["loss"])

            wall, busy = busy_share(step)
            out[leg] = {"wall_ms": wall, "busy_ms": busy}
        elif leg == "real_table":
            out[leg] = real_table_steps(dev, mesh)
        elif leg == "tp":
            # every rank makes the (data, model) groups here, in order
            _, out[leg] = dp_fit(ds, dev, make_mesh_2d(DP_TP, None, dev),
                                 {"tp": DP_TP})
    multihost.shutdown()
    with open(os.path.join(os.path.dirname(spec_path),
                           f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def launch_ranks(world, backend, shared, legs, work):
    """Phase 19's ranks as fresh interpreters (spawned, not forked), each
    under DP_RANK_TIMEOUT; returns their reports in rank order."""
    os.makedirs(work, exist_ok=True)
    spec_path = os.path.join(work, "spec.json")
    with open(spec_path, "w") as f:
        json.dump({"world": world, "backend": backend, "shared": shared,
                   "legs": list(legs), "port": multihost.free_port(),
                   "weights": os.path.join(work, "weights.pt")}, f)
    script = os.path.abspath(__file__)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, script, "--dp-rank", str(r),
                               spec_path], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            remaining = DP_RANK_TIMEOUT - (time.perf_counter() - t0)
            outs.append(p.communicate(timeout=max(remaining, 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode:
            print(text[-6000:], flush=True)
        require(p.returncode == 0, f"rank {r} of {world} ({backend}) "
                f"exited {p.returncode}")
    reports = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    print(f"{world} ranks ({backend}{', one card' if shared else ''}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return reports


def locality_reference(dev, ds, world):
    """A one-process run of phase 19's sharded leg's batches: the
    Batcher's locality batches for ``world`` shards of the table, each
    stepped whole with the replicated cache. Per-step (losses, accs)."""
    cfg = dp_model_cfg()
    model = build_model(cfg, ds["train"], device=dev, seed=SEED)
    loader = Batcher(ds["train"], TRAIN_B, shuffle=True, seed=SEED,
                     drop_last=True, materialize=False,
                     partitions=shard_partitions(ds, world),
                     n_partitions=world)
    optimizer, scheduler = make_optimizer(model, dp_train_cfg(), len(loader))
    cache = make_feature_cache(ds["train"], TrainConfig(), cfg.compute_dtype,
                               dev)
    image_fn = make_image_fn(cache, cfg.compute_dtype)
    losses, accs = [], []
    for batch in loader:
        m = train_step(model, optimizer, scheduler, batch, None, image_fn)
        losses.append(float(m["loss"]))
        accs.append(100.0 * float(m["score"]) / max(float(m["valid"]), 1.0))
    return losses, accs


def compare_runs(label, got, want_losses, want_accs, tol=2e-3):
    rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want_losses)]
    print(f"{label}: per-step relative loss difference "
          + json.dumps(rel) + f"; accuracies {got['accs']} vs "
          f"{want_accs}", flush=True)
    require(len(got["losses"]) == len(want_losses) and max(rel) <= tol,
            f"{label}: losses beyond {tol} of the one-process run")
    require(got["accs"] == want_accs,
            f"{label}: a step's argmax scored otherwise")


def check_rank_reports(label, reports, legs):
    for leg in legs:
        shas = {r[leg]["sha"] for r in reports}
        require(len(shas) == 1, f"{label} {leg}: ranks' weights differ")
        for r in reports:
            require(r[leg]["per_step"] == CACHE_STEP_LAUNCHES,
                    f"{label} {leg}: rank {r['rank']} launches per step "
                    f"{r[leg]['per_step']}, want {CACHE_STEP_LAUNCHES}")


def dp_two_ranks_one_card(dev, smi, ds, ref, ref_model, work):
    """Phase 19 (a): two ranks on card 0 over gloo, against the
    one-process fit ``ref``."""
    reports = launch_ranks(2, "gloo", True,
                           DP_LEGS_A + ("evaluate", "all_reduce"), work)
    r0 = reports[0]
    check_rank_reports("(a)", reports, DP_LEGS_A)
    compare_runs("(a) replicated, 2 ranks vs 1 process", r0["replicated"],
                 ref["losses"], ref["accs"])
    loc_losses, loc_accs = locality_reference(dev, ds, 2)
    compare_runs("(a) sharded, 2 ranks vs 1 process on its locality "
                 "batches", r0["sharded"], loc_losses, loc_accs)
    bf = r0["bf16"]
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(bf["losses"], r0["replicated"]["losses"]))
    print(f"(a) bf16 reduce: losses {bf['losses'][0]:.5f} -> "
          f"{bf['losses'][-1]:.5f}, max relative difference from the "
          f"f32 reduce {rel:.3g}", flush=True)
    require(rel <= 2e-3, "the bf16 reduce's losses left the f32 one's")
    require(statistics.mean(bf["losses"][-5:])
            < statistics.mean(bf["losses"][:5]),
            "the bf16 reduce does not learn")
    # evaluate over two ranks: rank 0's result.json, equal to one
    # process's on the same weights
    model = build_model(dp_model_cfg(), ds["val"], device=dev)
    model.load_state_dict(torch.load(os.path.join(work, "weights.pt"),
                                     weights_only=True))
    one_path = os.path.join(work, "result_one.json")
    acc, _, _ = evaluate(model, ds["val"], TRAIN_B, result_path=one_path,
                         device=dev)
    with open(one_path) as f, open(os.path.join(
            work, "result_rank0.json")) as g:
        one, two = json.load(f), json.load(g)
    require(one == two and r0["evaluate"]["acc"] == acc,
            "evaluate over two ranks differs from one process")
    require(not os.path.exists(os.path.join(work, "result_rank1.json")),
            "rank 1 wrote a result.json")
    # the two trainings' models answer alike: the argmax over 3001
    # answers after 20 steps whose gradients were summed in two orders
    _, alone, _ = evaluate(ref_model, ds["val"], TRAIN_B, result_path=None,
                           device=dev)
    agree = sum(a == b for a, b in zip(one, alone)) / len(one)
    numbers = {
        "step_ms": {k: r0[k]["step_ms"] for k in DP_LEGS_A},
        "gloo_all_reduce_ms": r0["all_reduce"],
        "launches_per_rank_step": r0["replicated"]["per_step"],
        "evaluate_launches_rank0": r0["evaluate"]["launches"],
        "answers_equal_to_one_process_training": agree}
    print(f"(a) 2 ranks on one card (gloo): result.json of {len(two)} "
          f"answers equal to one process's, accuracy {acc:.3f}; "
          + json.dumps(numbers) + f" ({smi})", flush=True)
    require(agree >= 0.98, "the 2-rank model answers otherwise than the "
            "one-process model on more than 2% of val")
    return numbers


def tp_numbers(report):
    """The printed numbers of a tensor-parallel fit's rank report."""
    t = report["tp"]
    return {"step_ms": report["step_ms"],
            "all_gather_ms": t["all_gather_ms"],
            "write_back_ms": t["write_back_ms"],
            "all_gather_mb": t["all_gather_bytes"] / 1e6,
            "moment_mb_rank": t["moment_bytes_rank"] / 1e6,
            "moment_mb_whole": t["moment_bytes_whole"] / 1e6,
            "sharded_params": t["sharded_params"], "params": t["params"],
            "sharded": t["sharded"]}


def dp_tp_one_card(smi, ref, work):
    """Phase 19 (e): dp 1 x tp 2, two ranks on card 0 over gloo, against
    the one-process fit ``ref``: equal bit for bit (a data group of one
    sums nothing; the slices, Adam and the all-gather are exact)."""
    reports = launch_ranks(2, "gloo", True, ("tp",), work)
    check_rank_reports("(e)", reports, ("tp",))
    r0 = reports[0]["tp"]
    require(r0["losses"] == ref["losses"] and r0["sha"] == ref["sha"],
            "(e) dp 1 x tp 2 differs from the one-process fit")
    numbers = tp_numbers(r0)
    print("(e) dp 1 x tp 2 on one card (gloo): losses and weights equal "
          "to the one-process fit bit for bit; per rank per step "
          + json.dumps(r0["per_step"]) + "; " + json.dumps(numbers)
          + f" ({smi})", flush=True)
    return numbers


def dp_nccl_world_one(dev, ds, ref):
    """Phase 19 (b): NCCL at world 1 on this card, the data-parallel
    path, equal to the single-card fit bit for bit."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method="tcp://localhost:"
                            f"{multihost.free_port()}", world_size=1,
                            rank=0)
    try:
        _, b = dp_fit(ds, dev, make_mesh(None, dev))
    finally:
        dist.destroy_process_group()
    require(b["losses"] == ref["losses"] and b["sha"] == ref["sha"],
            "the NCCL world-1 fit differs from the plain fit")
    print("(b) NCCL at world 1: losses and weights equal to the "
          "single-card fit bit for bit", flush=True)


def dp_nccl_cards(smi, ref, work):
    """Phase 19 (c): NCCL over every visible card (up to 4) against the
    one-card fit ``ref``, or a line saying why it did not run."""
    cards = min(torch.cuda.device_count(), 4)
    if cards < 2:
        print(f"(c) NCCL over several cards did not run: "
              f"{torch.cuda.device_count()} card visible", flush=True)
        return None
    # the VQA v2 bf16 table shards under the default budget from 3 cards
    # up (18.25 GB / 2 exceeds 8 GiB)
    table = VQA_IMAGES * 36 * (FULL["feat_dim"] - 4) * 2
    real = table / cards <= TrainConfig().device_cache_bytes
    if not real:
        print(f"(c) the VQA v2 table ({table / 1e9:.2f} GB bf16) does not "
              f"shard into {cards} cards under the 8 GiB budget: its leg "
              "did not run", flush=True)
    tp = cards % DP_TP == 0
    if not tp:
        print(f"(c) dp x tp {DP_TP} did not run: {cards} cards", flush=True)
    reports = launch_ranks(cards, "nccl", False, (
        "replicated", "bf16", "all_reduce", "busy")
        + (("real_table",) if real else ()) + (("tp",) if tp else ()), work)
    r0 = reports[0]
    check_rank_reports("(c)", reports, ("replicated", "bf16"))
    compare_runs(f"(c) replicated, {cards} cards vs 1 card",
                 r0["replicated"], ref["losses"], ref["accs"])
    numbers = {
        "cards": cards,
        "step_ms": {k: r0[k]["step_ms"] for k in ("replicated", "bf16")},
        "busy": r0["busy"], "nccl_all_reduce_ms": r0["all_reduce"],
        "real_table": [r.get("real_table") for r in reports]}
    if tp:
        for r in reports:
            require(r["tp"]["per_step"] == CACHE_STEP_LAUNCHES,
                    f"(c) tp: rank {r['rank']} launches per step "
                    f"{r['tp']['per_step']}, want {CACHE_STEP_LAUNCHES}")
            require(r["tp"]["sha"] == reports[r["rank"] - r["rank"] % DP_TP]
                    ["tp"]["sha"], f"(c) tp: rank {r['rank']}'s weights "
                    "differ from its model group's")
        label = f"(c) dp {cards // DP_TP} x tp {DP_TP}, {cards} cards"
        compare_runs(label + " vs 1 card", r0["tp"], ref["losses"],
                     ref["accs"])
        numbers["tp"] = tp_numbers(r0["tp"])
        numbers["tp"]["weights_equal_on_every_rank"] = len(
            {r["tp"]["sha"] for r in reports}) == 1
        numbers["tp"]["per_step"] = r0["tp"]["per_step"]
        print(f"{label} (NCCL): weights equal within each model group; "
              + json.dumps(numbers["tp"]) + f" ({smi})", flush=True)
    print(f"(c) {cards} cards (NCCL): " + json.dumps(numbers) + f" ({smi})",
          flush=True)
    return numbers


def dp_serving(dev, one_card):
    """Phase 19 (d): InferenceServer split over [dev, dev] (with
    ``one_card``) and over every card where there are several, the
    unmerged and the merged bf16 model; top-1 equal to one device's on
    64 requests."""
    device_sets = [[dev, dev]] if one_card else []
    if torch.cuda.device_count() > 1:
        device_sets.append([torch.device("cuda", i) for i in
                            range(torch.cuda.device_count())])
    for merged in (False, True):
        model16 = GraphVQAModel(ModelConfig(**FULL, merged_block=merged),
                                device=dev, seed=SEED)
        sds = ServingData(model16.cfg, 64, SEED)
        jobs = serving_jobs(
            [f"w{i}" for i in range(1, model16.cfg.vocab_size)],
            [str(100 + i) for i in range(64)], 64, SEED + 19)
        want = direct_top1(model16, sds, jobs, dev, SERVE_B)
        for devices in device_sets:
            n = len(devices)
            srv = InferenceServer(model16, sds, devices=devices,
                                  batch_size=SERVE_B if SERVE_B % n == 0
                                  else SERVE_B * n)
            try:
                futures = [srv.submit(q, image_id=iid) for q, iid in jobs]
                got = [f.result(120)["answer"] for f in futures]
            finally:
                srv.close()
            same = sum(a == b for a, b in zip(got, want))
            print(f"(d) serving the {'merged' if merged else 'unmerged'} "
                  f"model over {[str(d) for d in devices]}: top-1 equal to "
                  f"one device on {same}/{len(jobs)} requests", flush=True)
            require(same == len(jobs), "split serving answered otherwise")


def data_parallel(dev, smi, legs="abcde"):
    """Phase 19, the main path over several ranks: (a) two ranks on card
    0 over gloo; (b) NCCL at world 1; (c) NCCL over every visible card
    (up to 4), with dp x tp 2 over them, or a line saying why not; (d)
    serving split over devices; (e) dp 1 x tp 2 on card 0 over gloo.
    ``legs`` "cd" runs only what needs several cards, with the one-card
    fit they are held against."""
    t_phase = time.perf_counter()
    ds = train_dataset()
    numbers = {}
    # the one-process run every data-parallel run is held against
    ref_model, ref = dp_fit(ds, dev, None, cache=make_feature_cache(
        ds["train"], TrainConfig(), "bfloat16", dev))
    require(ref["per_step"] == CACHE_STEP_LAUNCHES,
            f"one-process launches per step {ref['per_step']}")
    numbers["one_card_step_ms"] = ref["step_ms"]
    work = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        if "a" in legs:
            numbers["a"] = dp_two_ranks_one_card(dev, smi, ds, ref,
                                                 ref_model,
                                                 os.path.join(work, "a"))
        if "b" in legs:
            dp_nccl_world_one(dev, ds, ref)
        if "c" in legs:
            numbers["c"] = dp_nccl_cards(smi, ref, os.path.join(work, "c"))
        if "e" in legs:
            numbers["e"] = dp_tp_one_card(smi, ref, os.path.join(work, "e"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if "d" in legs:
        dp_serving(dev, one_card="a" in legs)
    print(f"phase 19 ({legs}) in {time.perf_counter() - t_phase:.1f} s "
          f"({smi}): " + json.dumps(numbers), flush=True)
    return numbers

# ---------------- phase 20: the fused Adam kernel ----------------


def param_shapes(cfg, dev):
    """The parameter shapes of ``cfg``'s model at its widths, and two
    empty tensors."""
    model = make_model(cfg, device=dev, seed=0)
    shapes = [tuple(p.shape) for p in model.parameters()] + [(0,), (3, 0)]
    del model
    torch.cuda.empty_cache()
    return shapes


def adam_lists(shapes, mu, nu, dev, seed=SEED):
    """(params, grads, mus, nus) on ``dev`` for Adam in ``shapes``, or
    with ``shapes`` None as views at offsets that no 16-byte access fits
    (a tensor-parallel shard's: odd starts in one buffer each, an empty
    one among them): parameters N(0, 1), gradients over six decades with
    5% exactly 0, moments in ``mu`` / ``nu`` and not zero."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cuts = None
    if shapes is None:
        cuts, at = [], 1
        for n in (999, 4003, 0, 17, 65539):
            cuts.append((at, at + n))
            at += n + 3
        shapes = [(b - a,) for a, b in cuts]

    def rand(shape, dtype=torch.float32, kind="normal"):
        x = (torch.randn if kind == "normal" else torch.rand)(
            shape, generator=g, device=dev)
        return x.to(dtype)

    def place(ts, dtype):
        if cuts is None:
            return ts
        flat = torch.empty(cuts[-1][1] + 3, dtype=dtype, device=dev)
        return [flat[a:b].copy_(t) for (a, b), t in zip(cuts, ts)]

    ps = [rand(s) for s in shapes]
    gs = [rand(s) * 10.0 ** torch.randint(-4, 2, s, generator=g, device=dev)
          * (rand(s, kind="uniform") > 0.05) for s in shapes]
    mus = [(rand(s) * 1e-2).to(mu) for s in shapes]
    nus = [(rand(s, kind="uniform") * 1e-3).to(nu) for s in shapes]
    return (place(ps, torch.float32), place(gs, torch.float32),
            place(mus, mu), place(nus, nu))


def adam_scalars(t, dev, lr=1e-4, betas=(0.9, 0.999)):
    """(lr, 1 - b1^t, 1 - b2^t) of step t as Adam's host part forms them."""
    bc = [float(1 - torch.tensor(b, dtype=torch.float32) ** t)
          for b in betas]
    return torch.tensor([lr, *bc], dtype=torch.float32, device=dev)


def adam_bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def check_adam(table, ps, gs, mus, nus, label, steps=3):
    """``steps`` of adam_fused_step on ``table`` (made of the four lists)
    against the plain version on copies, bit for bit. Returns the
    copies."""
    ref = [[t.clone() for t in x] for x in (ps, gs, mus, nus)]
    for t in range(1, steps + 1):
        scalars = adam_scalars(t, ps[0].device)
        adam_fused_step(table, scalars)
        lr, bc1, bc2 = scalars.tolist()
        ref[2], ref[3] = adam_reference(ref[0], ref[1], ref[2], ref[3],
                                        lr, bc1, bc2)
    torch.cuda.synchronize()
    for name, got, want in (("parameters", ps, ref[0]), ("mu", mus, ref[2]),
                            ("nu", nus, ref[3])):
        bad = sum(not torch.equal(adam_bits(a), adam_bits(b))
                  for a, b in zip(got, want))
        require(bad == 0, f"adam_fused_step at {label}: {bad} of "
                f"{len(got)} {name} tensors differ from the plain "
                "version's bits")
    return ref


def check_and_time_adam(dev, label, cfg, mu, nu):
    """adam_fused_step at ``cfg``'s parameter list: three steps against
    the plain version bit for bit, then timed. Returns the timing entry."""
    ps, gs, mus, nus = adam_lists(param_shapes(cfg, dev), mu, nu, dev)
    n = sum(p.numel() for p in ps)
    table = AdamTable(ps, gs, mus, nus)
    table.upload()
    ref = check_adam(table, ps, gs, mus, nus, f"{label} ({mu}, {nu})")
    scalars = adam_scalars(4, dev)
    library = None
    if mu == nu == torch.float32:
        leaves = [torch.nn.Parameter(p.clone()) for p in ps]
        for leaf, grad in zip(leaves, gs):
            leaf.grad = grad.clone()
        # a yardstick only: the port never calls a library optimizer
        lib = torch.optim.Adam(leaves, lr=1e-4, fused=True)
        library = lib.step
    # p read and written, g read, each moment read and written
    nbytes = n * (3 * 4 + 2 * (torch.empty((), dtype=mu).element_size()
                                   + torch.empty((), dtype=nu).element_size()))
    t = timed(lambda: adam_fused_step(table, scalars),
              lambda: adam_reference(ref[0], ref[1], ref[2], ref[3], 1e-4,
                                     0.1, 0.001), nbytes, 0.0, library)
    entry = {"name": f"adam_fused_step {label} {str(mu)[6:]}/{str(nu)[6:]}",
             "parameters": n, "tensors": len(ps), "chunks": table.chunks,
             "bytes": nbytes, **t,
             "bound_share": t["bound_ms"] / t["ms"]}
    print(json.dumps(entry), flush=True)
    return entry


def adam_launches_per_step(dev, gen, n=8):
    """Full-width bf16 train steps at B = 64: one adam_fused_step launch
    a step, the first eager and the rest inside the step's graph."""
    cfg = ModelConfig(**FULL)
    model = GraphVQAModel(cfg, device=dev, seed=SEED)
    optimizer, scheduler = make_optimizer(model, TrainConfig(), 100)
    generator = torch.Generator(device=dev).manual_seed(SEED)
    batch = random_train_batch(TRAIN_B, cfg, gen)
    launches = adam_fused_step.launches
    t0 = time.perf_counter_ns()
    for _ in range(n):
        train_step(model, optimizer, scheduler, batch, generator)
    torch.cuda.synchronize()
    per_step = (adam_fused_step.launches - launches) / n
    graphed = [c[1] for c in profiling.recent_counts()
               if c[0] == "adam.graphed" and c[2] >= t0]
    print(f"adam_fused_step launches per full-width train step: "
          f"{per_step}; adam.graphed per step: {graphed}", flush=True)
    require(per_step == 1 and graphed == [0] + [1] * (n - 1),
            f"Adam per step: {per_step} launches, adam.graphed {graphed}")


def fused_adam(dev, gen):
    """Phase 20 (see the module's docstring)."""
    entries = []
    for label, cfg in (("vqa2", ModelConfig(**FULL)),
                       ("mcan_large", ModelConfig(**MCAN_LARGE))):
        for dt in (torch.float32, torch.bfloat16):
            entries.append(check_and_time_adam(dev, label, cfg, dt, dt))
    for dt in (torch.float32, torch.bfloat16):
        lists = adam_lists(None, dt, dt, dev)
        table = AdamTable(*lists)
        table.upload()
        check_adam(table, *lists, f"unaligned shards ({dt})")
    print("adam_fused_step equals the plain version bit for bit at "
          "unaligned shards, f32 and bf16 moments", flush=True)
    adam_launches_per_step(dev, gen)
    print(f"adam_fused_step.cu ptxas:\n{_build.resource_report('adam')}",
          flush=True)
    return entries


def main(argv) -> int:
    if argv[:1] == ["--dp-rank"]:
        return dp_rank(argv[1:])
    only_dp = {("--phase", "19"): "abcde", ("--phase", "19c"): "cd"}.get(
        tuple(argv))
    only_adam = tuple(argv) == ("--phase", "20")
    if argv and not (only_dp or only_adam):
        print("usage: chip_smoke.py [--phase 19 | --phase 19c | --phase 20]",
              file=sys.stderr)
        return 2
    phase("1 device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    phase("2 build")
    print(f"built {', '.join(_build.KERNELS)} in {_build.build_all():.2f} s "
          f"into {_build.build_dir()}", flush=True)
    for name in _build.KERNELS:
        print(f"{name}.cu ptxas:\n{_build.resource_report(name)}", flush=True)

    gen = torch.Generator().manual_seed(SEED)
    if only_adam:
        phase("20 the fused Adam kernel")
        entries = fused_adam(dev, gen)
        print(smi, flush=True)
        print(json.dumps({"kernels": entries}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if only_dp:
        phase("19 data parallelism (main path)")
        data_parallel(dev, smi, only_dp)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    phase("3 kernels against their plain versions")
    errs = check_kernels(dev, gen)
    phase("4 full-width forward")
    serve_model = full_width_forward(dev, gen)
    phase("5 serving (main path)")
    launches = serve(serve_model, dev)
    phase("6 timing (serving)")
    entries = measure(dev, gen, launches, errs, serve_model)
    phase("7 training kernels against their plain versions")
    check_edge_training(dev, gen, errs)
    check_gru_training(dev, gen, errs)
    phase("8 one training step, card against CPU")
    train_step_card_vs_cpu(dev, gen)
    phase("9 training (main path)")
    ds = train_dataset()
    _, host_losses, counts, _ = run_fit(dev, ds, None, "host mode")
    phase("6 timing (training)")
    entries += measure_training(dev, gen, counts, errs)
    phase("10 gather kernels against their plain versions")
    errs.update(check_gathers(dev))
    errs["gather_image_rows"] = check_image_gathers(dev)
    phase("11 training with the device cache (main path)")
    cache = make_feature_cache(ds["train"], TrainConfig(),
                               ModelConfig().compute_dtype, dev)
    model, cache_losses, cache_counts, cache_step_ms = train_cache_main_path(
        dev, ds, cache, host_losses)
    phase("12 evaluate to result.json")
    evaluate_checks(dev, model, ds, cache)
    phase("13 merged-block kernels against their plain versions")
    errs["tile_gemm"] = check_tile_gemm(dev, gen)
    errs["wgmma_gemm"] = check_wgmma_gemm(dev, gen)
    check_graph_block(dev, gen, errs)
    phase("14 training with the merged block (main path)")
    _, merged_counts = train_merged_main_path(dev, ds, cache, cache_losses)
    merged_serving_forward(dev, gen, serve_model)
    phase("6 timing (device cache)")
    entries += time_gathers(dev, cache_counts, errs)
    entries += time_image_gathers(dev, cache_counts, errs)
    time_cache_steps(dev, gen)
    time_evaluate(dev, model, ds, cache)
    phase("6 timing (merged block)")
    entries += time_graph_block(dev, gen, merged_counts, errs)
    time_merged_steps(dev)
    old_cwd = os.getcwd()
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        os.chdir(work)
        phase("15 the CLI from files (main path)")
        sdir = cli_main_path(dev, smi, cache_step_ms)
        phase("16 the serving CLI from files (main path)")
        serving_from_files(dev, smi, sdir)
        os.makedirs("medical")
        os.chdir("medical")
        phase("17 the medical grid search from files (main path)")
        medical_grid_search(dev, gen, smi, errs)
        os.chdir(work)
        phase("18 the interpretability plots from files (main path)")
        plots_from_files(dev, smi, sdir)
    finally:
        os.chdir(old_cwd)
        shutil.rmtree(work, ignore_errors=True)
    phase("19 data parallelism (main path)")
    data_parallel(dev, smi)
    phase("20 the fused Adam kernel")
    entries += fused_adam(dev, gen)

    print(smi, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
