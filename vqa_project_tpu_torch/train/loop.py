"""The training loop, the device feature cache and evaluation.

Counterpart of ``vqa_project_tpu/train/loop.py``, on one card or over
the data-parallel ranks of a process group (``parallel``):

- ``make_feature_cache`` puts the dataset's feature table on the device
  when it fits ``device_cache_bytes`` (as a (features, boxes) pair in
  the cache dtype on every rank, or int8 with per-box scales), else
  splits it over the ranks when a share fits
  (``parallel.ShardedFeatureCache``), else returns None: host mode,
  dense batches from the host;
- ``fit`` (what ``cli/run.py --train`` / ``--trainval`` call): shuffled
  fixed-shape batches prefetched to the device, one ``train_step`` each,
  the loss and accuracy logged per window of ``log_interval`` steps (one
  device-to-host fetch per window), the epoch accuracy, every
  ``eval_interval`` steps a 10-batch mini-validation plus a checkpoint,
  optionally a checkpoint per epoch, and resuming from the port's own
  checkpoint, a reference ``.pt`` or a JAX-package checkpoint;
- ``evaluate`` (``--eval`` / ``--test``): the accuracy over a split and
  the EvalAI ``result.json`` ([{question_id, answer}]), through a
  resident epoch with a cache, else streaming.

Over several ranks every rank builds the same global batch and runs its
rows of it (``--bsize`` is the global batch); the logged sums, the
mini-validation's and evaluate's scores are summed over the ranks, the
predictions gathered (``multihost.fetch_global``), and only rank 0
writes checkpoints, ``metrics.jsonl`` and ``result.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vqa_project_tpu_torch.config import (ModelConfig, TrainConfig,
                                          resolve_device, torch_dtype)
from vqa_project_tpu_torch.data.datasets import GraphVQADataset
from vqa_project_tpu_torch.data.loader import Batcher, prefetch_to_device
from vqa_project_tpu_torch.models.graph_vqa import GraphVQAModel
from vqa_project_tpu_torch.ops.quant import quantize_feature_table
from vqa_project_tpu_torch.parallel import multihost
from vqa_project_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from vqa_project_tpu_torch.parallel.sharded_cache import ShardedFeatureCache
from vqa_project_tpu_torch.train.metrics import MetricLogger, window_sums
from vqa_project_tpu_torch.train.profiling import StepTimer, force_sync
from vqa_project_tpu_torch.train.state import (load_checkpoint,
                                               make_optimizer,
                                               save_checkpoint)
from vqa_project_tpu_torch.train.steps import (QuantizedFeatureCache,
                                               eval_epoch, eval_step,
                                               make_image_fn,
                                               stack_epoch_batches,
                                               supports_bf16_reduce,
                                               train_step)

# images per host chunk while a cache is uploaded (~300 MB of f32 at the
# VQA v2 widths)
_UPLOAD_ROWS = 1024
# sentinel telling "not passed" (build a cache) from None (host mode)
_UNSET = object()


def build_model(model_cfg: ModelConfig, ds: GraphVQADataset, *,
                device="cuda", seed: int = 1000) -> GraphVQAModel:
    """The model at the dataset's widths (vocabulary, embedding, feature,
    answer and object counts, question length), weights from ``seed``
    and the dataset's word embeddings."""
    cfg = dataclasses.replace(
        model_cfg, vocab_size=ds.q_words,
        emb_dim=ds.pretrained_wemb.shape[1], feat_dim=ds.feat_dim,
        out_dim=ds.n_answers, n_obj=ds.n_obj, max_qlen=ds.max_qlen)
    model = GraphVQAModel(cfg, device=device, seed=seed)
    with torch.no_grad():
        model.wembed.weight.copy_(torch.from_numpy(ds.pretrained_wemb))
    return model


def _upload(table: np.ndarray, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """``table`` on ``device`` in ``dtype``, sent in f32 chunks and cast
    there, so no full-size host copy in the cache dtype is made."""
    out = torch.empty(table.shape, dtype=dtype, device=device)
    for i in range(0, table.shape[0], _UPLOAD_ROWS):
        chunk = np.ascontiguousarray(table[i:i + _UPLOAD_ROWS], np.float32)
        if not chunk.flags.writeable:   # a packed store's read-only memmap
            chunk = chunk.copy()
        out[i:i + len(chunk)].copy_(torch.from_numpy(chunk).to(device))
    return out


def _make_int8_cache(store, train_cfg: TrainConfig, compute_dtype: str,
                     device: torch.device):
    """The int8 row-quantized cache, or None when even int8 exceeds the
    budget. Quantized on the host one chunk at a time."""
    n, k, f = store.features.shape
    nbytes = n * k * f + n * k * 4 + store.boxes.nbytes
    if nbytes > train_cfg.device_cache_bytes:
        print(f"int8 feature table {nbytes / 1e9:.1f} GB still exceeds "
              "the device cache budget; using the host mode at the "
              "compute dtype", flush=True)
        return None
    q = torch.empty((n, k, f), dtype=torch.int8, device=device)
    scales = torch.empty((n, k), dtype=torch.float32, device=device)
    for i in range(0, n, _UPLOAD_ROWS):
        qc, sc = quantize_feature_table(store.features[i:i + _UPLOAD_ROWS])
        q[i:i + len(qc)].copy_(torch.from_numpy(qc).to(device))
        scales[i:i + len(sc)].copy_(torch.from_numpy(sc).to(device))
    boxes = _upload(store.boxes, torch.float32, device)
    return QuantizedFeatureCache(features=q, scales=scales, boxes=boxes,
                                 out_dtype=compute_dtype or "float32")


def make_feature_cache(ds: GraphVQADataset, train_cfg: TrainConfig,
                       compute_dtype: Optional[str] = None, device="cuda",
                       mesh: Optional[Mesh] = None):
    """The dataset's feature table on ``device`` (``mesh.device`` with a
    mesh), or None (host mode).

    Mode selection by the per-card budget ``train_cfg.device_cache_bytes``,
    in this order: a table that fits in the cache dtype
    (``feature_cache_dtype``; "auto" means the compute dtype) becomes a
    (features, boxes f32) pair on every rank; "int8" becomes a
    ``QuantizedFeatureCache`` (replicated only), or the compute dtype
    when even int8 does not fit; a table that fits only divided over the
    mesh's ranks becomes a ``ShardedFeatureCache`` (rank r uploads only
    its rows); else None.
    """
    dev = resolve_device(device) if mesh is None else mesh.device
    world = 1 if mesh is None else mesh.world
    store = ds.store
    cache_dtype = train_cfg.feature_cache_dtype
    if cache_dtype == "auto":
        cache_dtype = compute_dtype or "float32"
    if cache_dtype == "int8":
        qc = _make_int8_cache(store, train_cfg, compute_dtype, dev)
        if qc is not None:
            return qc
        cache_dtype = compute_dtype or "float32"
    dtype = torch_dtype(cache_dtype)
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = store.features.size * itemsize + store.boxes.nbytes
    if nbytes <= train_cfg.device_cache_bytes:
        return (_upload(store.features, dtype, dev),
                _upload(store.boxes, torch.float32, dev))
    if world > 1 and nbytes / world <= train_cfg.device_cache_bytes:
        print(f"feature table {nbytes / 1e9:.1f} GB: sharding across "
              f"{world} ranks ({nbytes / world / 1e9:.1f} GB/rank)",
              flush=True)
        return ShardedFeatureCache.build(store, mesh, dtype)
    print(f"feature table {nbytes / 1e9:.1f} GB exceeds device cache "
          "budget; streaming features from host", flush=True)
    return None


def _batches_forever(batcher: Batcher):
    while True:
        yield from batcher


def _rank_part(mesh: Mesh, cache):
    """The function from a global host batch to this rank's part of it
    (its rows; with a sharded cache their image rows in its shard), or
    None at world 1."""
    if mesh.world == 1:
        return None
    sharded = isinstance(cache, ShardedFeatureCache)

    def part(batch):
        local = shard_batch(batch, mesh)
        if sharded:
            local = {**local, "image_row": cache.local_rows(
                local["image_row"])}
        return local

    return part


def _locality_kwargs(cache, ds: GraphVQADataset, mesh: Mesh) -> dict:
    """Batcher kwargs: locality batches over a sharded cache, and in host
    mode the dense fields of this rank's rows only."""
    if isinstance(cache, ShardedFeatureCache):
        return {"partitions": cache.partitions()[ds.table.image_row],
                "n_partitions": mesh.world}
    if cache is None and mesh.world > 1:
        return {"shard": (mesh.rank, mesh.world)}
    return {}


def mini_validation(model, val_iter, n_batches: int = 10,
                    part=None) -> float:
    """Accuracy (%) over ``n_batches`` random host-mode validation
    batches, streamed, summed over the ranks (``part``: a rank's part of
    a batch); the denominator counts only unpadded rows."""
    scores, n_valid = [], 0.0
    for _ in range(n_batches):
        batch = next(val_iter)
        n_valid += float(batch["mask"].sum())
        _, score, _ = eval_step(model, batch if part is None
                                else part(batch))
        scores.append(score)
    scores = multihost.all_reduce_sum(torch.stack(scores))
    correct = 0.0
    for s in scores.double().cpu().tolist():
        correct += s
    return correct / max(n_valid, 1.0) * 100.0


def mini_validation_resident(model, val_iter, image_fn, device,
                             n_batches: int = 10, part=None) -> float:
    """``mini_validation`` with a device feature cache: the 10 index
    batches (a rank's parts of them) go to the device in one copy and
    the summed score comes back in one fetch."""
    hosts = [next(val_iter) for _ in range(n_batches)]
    n_valid = float(sum(h["mask"].sum() for h in hosts))
    epoch, _ = stack_epoch_batches(
        hosts if part is None else [part(h) for h in hosts], device)
    total, _ = eval_epoch(model, epoch, image_fn)
    return (float(multihost.all_reduce_sum(total)) / max(n_valid, 1.0)
            * 100.0)


def _same_store(a, b) -> bool:
    """True when two FeatureStores are one object or backed by the same
    packed files (the VQA v2 train and val splits read one store)."""
    if a is b:
        return True
    fa = getattr(a.features, "filename", None)
    return fa is not None and fa == getattr(b.features, "filename", None)


def dropout_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s dropout generator: ``seed`` itself on
    rank 0 (the single-card stream), a stream of its own derived from
    (seed, rank) on the others."""
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(rank)])
               .generate_state(1)[0])


def _gather_generators(generator: torch.Generator,
                       mesh: Mesh) -> Optional[List[torch.Tensor]]:
    """Every rank's generator state, in rank order, on every rank (one
    all_reduce); None at world 1."""
    if mesh.world == 1:
        return None
    state = generator.get_state()
    buf = torch.zeros((mesh.world, state.numel()), dtype=torch.uint8,
                      device=mesh.device)
    buf[mesh.rank].copy_(state)
    multihost.all_reduce_sum(buf)
    # a tensor of its own per rank: set_state reads a view's storage
    # from its start, not from the view's offset
    return [row.clone() for row in buf.cpu()]


def _resume_checkpoint(path: str, model, optimizer, scheduler,
                       generator, mesh: Optional[Mesh] = None
                       ) -> Tuple[int, int, int]:
    """Restore training state from ``path`` (any kind
    ``load_checkpoint`` reads); returns (next epoch, steps already run
    in it, step). ``step_in_epoch > 0`` marks a checkpoint written
    mid-epoch at a mini-validation, by the port or by the JAX package; a
    reference ``.pt`` resumes at an epoch boundary. Every rank reads rank
    0's file and takes its own dropout generator's state from it when the
    file was written by as many ranks (else a rank past 0 keeps its
    fresh stream: rank 0's would repeat rank 0's bits)."""
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world)
    payload = load_checkpoint(path, model, optimizer, scheduler,
                              generator if rank == 0 else None)
    states = payload.get("rank_generators")
    if rank > 0 and states is not None and len(states) == world:
        generator.set_state(states[rank].clone())
    extra = payload.get("extra") or {}
    return (int(payload["epoch"]), int(extra.get("step_in_epoch", 0)),
            int(payload["step"]))


def fit(train_cfg: TrainConfig, model_cfg: ModelConfig,
        train_ds: GraphVQADataset,
        val_ds: Optional[GraphVQADataset] = None, *, device="cuda",
        resume_path: Optional[str] = None, save_every_epoch: bool = False,
        jsonl_path: Optional[str] = None, cache=_UNSET, val_cache=_UNSET,
        step_timer: Optional[StepTimer] = None, mesh: Optional[Mesh] = None
        ) -> Tuple[GraphVQAModel, torch.optim.Optimizer, float]:
    """Train for ``train_cfg.epochs`` epochs; returns (model, optimizer,
    accuracy % of the last epoch).

    ``cache`` and ``val_cache`` are prebuilt device feature caches, None
    for host mode, or (by default) built by ``make_feature_cache``, val's
    shared with train's when both read one store; a grid of fits passes
    them so that the table goes to the card once. Batches are
    shuffled per epoch from ``train_cfg.seed`` and the last partial batch
    is dropped: index batches with a cache, dense ones without,
    prefetched ``train_cfg.prefetch`` deep. Dropout draws from one
    generator on the device, seeded likewise. With ``val_ds``, every
    ``eval_interval`` steps of an epoch runs a mini-validation (resident
    with a cache) and writes ``{save_dir}/{name}_{epoch+1}.ckpt``;
    ``save_every_epoch`` writes it after every epoch too; ``jsonl_path``
    receives one record per logged window; ``step_timer`` times each
    step to its completion (a ``force_sync`` of its loss ends it).

    ``resume_path`` (a port checkpoint, a reference ``.pt`` or a JAX
    msgpack checkpoint; a missing file raises FileNotFoundError)
    continues from it: the epochs run are
    the checkpoint's next epoch and ``epochs - 1`` more, a mid-epoch
    checkpoint first finishing its epoch from the batch it stopped at,
    and the step count goes on from the checkpoint's. Resumed at either
    kind of checkpoint, the run repeats the uninterrupted one's steps bit
    for bit.

    ``mesh`` (default ``make_mesh(train_cfg.num_devices, device)``: the
    process group's ranks, or one card without a group) spreads each
    global batch of ``batch_size`` over the ranks: each builds the same
    batch and steps on its rows, the gradients summed over the ranks in
    ``train_cfg.grad_reduce_dtype`` (bf16 degrades to float32 with a
    sharded cache, as in JAX), and rank r > 0 draws dropout from a
    stream of its own (``dropout_seed``). The logged numbers are global
    and equal on every rank; only rank 0 writes files, its checkpoints
    holding every rank's generator state."""
    if resume_path and not os.path.isfile(resume_path):
        raise FileNotFoundError(f"resume checkpoint not found: {resume_path}")
    if mesh is None:
        mesh = make_mesh(train_cfg.num_devices, device)
    dev = mesh.device
    bs = train_cfg.batch_size
    if bs % mesh.world:
        raise ValueError(f"batch_size {bs} not divisible by {mesh.world} "
                         "data-parallel ranks")
    model = build_model(model_cfg, train_ds, device=dev,
                        seed=train_cfg.seed)
    if cache is _UNSET:
        cache = make_feature_cache(train_ds, train_cfg,
                                   model_cfg.compute_dtype, dev, mesh)
    image_fn = make_image_fn(cache, model_cfg.compute_dtype,
                             model_cfg.merged_block)
    part = _rank_part(mesh, cache)
    loader = Batcher(train_ds, bs, shuffle=True, seed=train_cfg.seed,
                     drop_last=True, materialize=cache is None,
                     **_locality_kwargs(cache, train_ds, mesh))
    steps_per_epoch = len(loader)
    optimizer, scheduler = make_optimizer(model, train_cfg, steps_per_epoch)
    generator = torch.Generator(device=dev).manual_seed(
        dropout_seed(train_cfg.seed, mesh.rank))
    grad_reduce = train_cfg.grad_reduce_dtype
    if grad_reduce == "bfloat16" and mesh.world > 1:
        ok, why = supports_bf16_reduce(cache)
        if not ok:
            print("grad_reduce_dtype=bfloat16 needs a replicated (or "
                  f"host-mode) feature cache; this run uses {why} — "
                  "falling back to the exact float32 gradient all-reduce",
                  flush=True)
            grad_reduce = "float32"
    step = start_epoch = resume_skip = 0
    if resume_path:
        print(f"Resuming from checkpoint {resume_path}", flush=True)
        start_epoch, resume_skip, step = _resume_checkpoint(
            resume_path, model, optimizer, scheduler, generator, mesh)
        if resume_skip:
            start_epoch -= 1
            print(f"Mid-epoch checkpoint: resuming epoch {start_epoch + 1} "
                  f"at step {resume_skip}/{steps_per_epoch}", flush=True)
        # epoch e's order is a function of (seed, e): the resumed epoch
        # sees the batches the uninterrupted run saw, less those done
        loader.set_epoch(start_epoch, skip=resume_skip)
    val_fn = None
    if val_ds is not None:
        if val_cache is _UNSET:
            val_cache = (cache if _same_store(val_ds.store, train_ds.store)
                         else make_feature_cache(val_ds, train_cfg,
                                                 model_cfg.compute_dtype,
                                                 dev, mesh))
        val_iter = _batches_forever(Batcher(
            val_ds, bs, shuffle=True, seed=train_cfg.seed + 1,
            materialize=val_cache is None,
            **_locality_kwargs(val_cache, val_ds, mesh)))
        val_part = _rank_part(mesh, val_cache)
        if val_cache is None:
            val_fn = lambda: mini_validation(  # noqa: E731
                model, val_iter, part=val_part)
        else:
            val_image_fn = make_image_fn(val_cache, model_cfg.compute_dtype,
                                         model_cfg.merged_block)
            val_fn = lambda: mini_validation_resident(  # noqa: E731
                model, val_iter, val_image_fn, dev, part=val_part)
    logger = MetricLogger(train_cfg.log_interval, jsonl_path,
                          n_chips=mesh.world, batch_size=bs)

    def checkpoint(ep: int, step_in_epoch: int) -> None:
        states = _gather_generators(generator, mesh)  # every rank
        if not multihost.is_primary():
            return
        save_checkpoint(
            os.path.join(train_cfg.save_dir, f"{train_cfg.name}_{ep + 1}.ckpt"),
            model, optimizer, scheduler, step=step, epoch=ep + 1,
            generator=generator, model_cfg=model.cfg, train_cfg=train_cfg,
            extra={"step_in_epoch": int(step_in_epoch)},
            rank_generators=states)

    epoch_acc = 0.0
    for ep in range(start_epoch, start_epoch + train_cfg.epochs):
        totals = np.zeros(3)           # loss, score, valid rows
        # n_steps is the position in the epoch (a resumed epoch's
        # mini-validations land where the uninterrupted run's did);
        # trained counts the steps run here, the loss's denominator
        n_steps = resume_skip if ep == start_epoch else 0
        trained = 0
        window = []

        def flush_window():
            # one all_reduce and one fetch for the whole window
            sums = window_sums(window)
            totals[:] += sums
            logger.log_window(epoch=ep, step=step, loss_sum=float(sums[0]),
                              score_sum=float(sums[1]), n=len(window),
                              examples=float(sums[2]),
                              lr=scheduler.get_last_lr()[0])
            window.clear()

        for host, batch in prefetch_to_device(iter(loader), dev,
                                              train_cfg.prefetch, part):
            with step_timer or contextlib.nullcontext():
                window.append(train_step(
                    model, optimizer, scheduler, batch, generator, image_fn,
                    mesh=mesh, n_valid=float(host["mask"].sum()),
                    grad_reduce_dtype=grad_reduce))
                if step_timer is not None:
                    force_sync(window[-1]["loss"])
            step += 1
            n_steps += 1
            trained += 1
            if len(window) >= logger.log_interval:
                flush_window()
            if (val_fn is not None and train_cfg.eval_interval
                    and n_steps % train_cfg.eval_interval == 0):
                acc = val_fn()
                print(f"Validation accuracy: {acc:.2f} %", flush=True)
                checkpoint(ep, n_steps % steps_per_epoch)
        if window:
            flush_window()
        epoch_acc = float(100.0 * totals[1] / max(totals[2], 1.0))
        print("Epoch %02d done, average loss: %.3f, average accuracy: "
              "%.2f%%" % (ep + 1, totals[0] / max(trained, 1), epoch_acc),
              flush=True)
        if save_every_epoch:
            checkpoint(ep, 0)
    logger.close()
    return model, optimizer, epoch_acc


def _emit(ds: GraphVQADataset, host_batch: Dict[str, np.ndarray],
          preds: np.ndarray, result: List[dict]) -> None:
    qids = host_batch["qid"]
    for i in np.flatnonzero(host_batch["mask"] > 0):
        result.append({"question_id": int(qids[i]),
                       "answer": ds.a_itow[int(preds[i])]})


def evaluate(model: GraphVQAModel, ds: GraphVQADataset, batch_size: int, *,
             result_path: Optional[str] = "result.json",
             collect_adjacency: bool = False,
             max_batches: Optional[int] = None, cache=_UNSET,
             train_cfg: Optional[TrainConfig] = None, device="cuda",
             mesh: Optional[Mesh] = None
             ) -> Tuple[float, List[dict], Optional[Dict[int, np.ndarray]]]:
    """Sequential evaluation: (accuracy %, the EvalAI result list
    [{question_id, answer}], adjacencies).

    With a device feature cache (``cache``, or built from ``train_cfg``'s
    cache fields) and no adjacency, the whole split runs as one resident
    epoch (one copy in, one fetch of the score and the predictions out);
    host mode or ``collect_adjacency`` streams batch by batch, and then
    ``adjacencies`` is a {dataset row: (K, K) array} dict, else None.
    ``max_batches`` stops early. The accuracy is over the valid rows
    seen; ``result_path`` (unless None) receives the result list.

    Over the ranks of ``mesh`` (default: the process group's, as in
    ``fit``) each rank runs its rows of every batch (locality batches
    with a sharded cache); the scores are summed and the predictions and
    adjacencies gathered over the ranks, so every rank returns the same
    three results, and only rank 0 writes ``result_path``.
    """
    dev = resolve_device(device)
    if next(model.parameters()).device != dev:
        raise ValueError(f"the model is on {next(model.parameters()).device}"
                         f", evaluate was asked for {dev}")
    if mesh is None:
        mesh = make_mesh(None, dev)
    if batch_size % mesh.world:
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"{mesh.world} data-parallel ranks")
    if cache is _UNSET:
        cache = make_feature_cache(ds, train_cfg or TrainConfig(
            batch_size=batch_size), model.cfg.compute_dtype, dev, mesh)
    image_fn = make_image_fn(cache, model.cfg.compute_dtype,
                             model.cfg.merged_block)
    part = _rank_part(mesh, cache)
    batches = iter(Batcher(ds, batch_size, shuffle=False,
                           materialize=cache is None,
                           **_locality_kwargs(cache, ds, mesh)))
    if max_batches is not None:
        batches = itertools.islice(batches, max_batches)

    result: List[dict] = []
    adjacencies = {} if collect_adjacency else None
    correct = n_valid = 0.0
    if cache is not None and not collect_adjacency:
        host_batches = list(batches)
        if host_batches:
            epoch, _ = stack_epoch_batches(
                host_batches if part is None
                else [part(h) for h in host_batches], dev)
            total, preds_all = eval_epoch(model, epoch, image_fn)
            correct = float(multihost.all_reduce_sum(total))
            preds_all = multihost.fetch_global(preds_all, axis=1)
            for host, preds in zip(host_batches, preds_all):
                n_valid += float(host["mask"].sum())
                _emit(ds, host, preds, result)
    else:
        for host, batch in prefetch_to_device(batches, dev, 2, part):
            preds, score, adjacency = eval_step(model, batch, image_fn)
            correct += float(multihost.all_reduce_sum(score))
            n_valid += float(host["mask"].sum())
            preds = multihost.fetch_global(preds)
            _emit(ds, host, preds, result)
            if collect_adjacency:
                adj = multihost.fetch_global(adjacency.float())
                for i in np.flatnonzero(host["mask"] > 0):
                    adjacencies[int(host["index"][i])] = adj[i]
    acc = correct / max(n_valid, 1.0) * 100.0
    if result_path and multihost.is_primary():
        with open(result_path, "w") as f:
            json.dump(result, f)
    return acc, result, adjacencies
