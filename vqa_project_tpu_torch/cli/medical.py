"""The grid-search harness of the medical VQA variants, on the card.

Counterpart of ``vqa_project_tpu/cli/medical.py`` (what
``run_imageclef`` and ``run_mimic`` run): for every (neighbourhood,
n_kernels) cell of the grid, train a fresh model for ``--ep`` epochs,
evaluate it sequentially on the validation split, append
``neighbors: N, kernels: K, Validation acc: X %`` to
``grid_search_nodes_{n_obj}.txt``, save the cell's checkpoint
``{prefix}_{n_obj}_{kernels}_{neigh}_{acc:.2f}.pt`` (a port checkpoint:
``train.load_checkpoint`` tells it from a reference ``.pt`` by its
content) and, for each cell that beats the best so far, write its
predictions CSV (``image_id,question,prediction,answer``) under
``--plot_dir``: the last one written is the best cell's.

The feature table goes to the card once per grid (train's, and val's
when val reads another store); each cell drops its model and optimizer
before the next. The accuracy divides by the number of validation
questions (the reference divides by n_train_batches * bsize and by
10 * bsize, copy-paste artifacts; PARITY.md, "Known deviations").

The flags and defaults are the JAX harness's, plus ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch versions of the
kernels), ``--adam_mu_dtype``, ``--adam_nu_dtype`` and ``--fast_math``
(as in ``cli/run.py``, less the gradient all-reduce's dtype, which the
JAX harness does not set), and the ``--synthetic_*`` sizes of the
``--synthetic`` set (the JAX harness always writes its generator's
default sizes).

``--num_devices N`` (default: every visible card) runs the whole grid
data-parallel over N ranks, as ``cli/run.py`` does: one process group
and one feature cache for the grid (JAX builds one mesh), each cell's
fit and evaluate over all ranks, and only rank 0 writing the grid file,
the CSVs, the checkpoints and the synthetic set (behind a barrier that
every rank reaches).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import sys
import time
from typing import Dict, List, Optional

from vqa_project_tpu_torch.cli.run import (add_adam_dtype_args,
                                           ensure_synthetic,
                                           resolve_dtype_knobs)
from vqa_project_tpu_torch.config import ModelConfig, TrainConfig
from vqa_project_tpu_torch.data import GraphVQADataset
from vqa_project_tpu_torch.data.synthetic_medical import (
    generate_synthetic_imageclef, generate_synthetic_mimic)
from vqa_project_tpu_torch.parallel import make_mesh, multihost
from vqa_project_tpu_torch.train import loop
from vqa_project_tpu_torch.train.profiling import StepTimer
from vqa_project_tpu_torch.train.state import adam_step, save_checkpoint


def _str2bool(s) -> bool:
    if isinstance(s, bool):
        return s
    v = s.strip().lower()
    if v in ("true", "t", "yes", "y", "1"):
        return True
    if v in ("false", "f", "no", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")


def medical_input_args(argv=None, *, n_obj_default=51, neigh_default=19):
    """(args, parser, unparsed arguments) of the medical harness."""
    parser = argparse.ArgumentParser(
        description="Conditional Graph Convolutions for VQA "
                    "(medical, PyTorch/CUDA)")
    # the reference's type=bool parses `--train False` as True; an
    # explicit str2bool makes False/0/no mean False (PARITY.md)
    parser.add_argument("--train", default=True, type=_str2bool,
                        nargs="?", const=True,
                        help="set this to training mode.")
    parser.add_argument("--n_kernels", type=int, default=8)
    parser.add_argument("--lr", metavar="", type=float, default=1e-3)
    parser.add_argument("--ep", metavar="", type=int, default=40)
    parser.add_argument("--bsize", type=int, default=8)
    parser.add_argument("--seed", type=int, default=1000)
    parser.add_argument("--hid", metavar="", type=int, default=1024)
    parser.add_argument("--emb", metavar="", type=int, default=300)
    parser.add_argument("--neighbourhood_size", type=int,
                        default=neigh_default)
    parser.add_argument("--n_obj", type=int, default=n_obj_default)
    parser.add_argument("--data_dir", metavar="", type=str, default="data")
    parser.add_argument("--save_dir", metavar="", type=str, default="save")
    parser.add_argument("--plot_dir", metavar="", type=str,
                        default="figures")
    parser.add_argument("--name", metavar="", type=str, default="gcn")
    parser.add_argument("--dropout", metavar="", type=float, default=0.4)
    parser.add_argument("--model_path", metavar="", type=str, default=None)
    parser.add_argument("--num_devices", type=int, default=None,
                        help="data-parallel ranks, one per card (default: "
                             "every visible card; with --device cpu, 1)")
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cpu runs the plain PyTorch "
                             "versions of the kernels)")
    add_adam_dtype_args(parser)
    parser.add_argument("--synthetic", action="store_true",
                        help="run on a generated synthetic set under "
                             "<data_dir>/synthetic_<dataset>")
    parser.add_argument("--synthetic_images", type=int, default=12,
                        help="images of the synthetic set (per split for "
                             "MIMIC); changing any --synthetic_* size "
                             "regenerates it")
    parser.add_argument("--synthetic_questions", type=int, default=64)
    parser.add_argument("--synthetic_feat_dim", type=int, default=32)
    parser.add_argument("--synthetic_vocab", type=int, default=24)
    parser.add_argument("--synthetic_answers", type=int, default=8)
    parser.add_argument("--neighbors_list", type=int, nargs="+",
                        default=[16, 20, 24, 28, 32, 36])
    parser.add_argument("--kernels_list", type=int, nargs="+",
                        default=[4, 8, 16, 32])
    args, unparsed = parser.parse_known_args(argv)
    return args, parser, unparsed


def make_configs(args):
    """(ModelConfig, TrainConfig) of the current cell's flags."""
    mu_dtype, nu_dtype = resolve_dtype_knobs(args)
    mcfg = ModelConfig(
        emb_dim=args.emb, hid_dim=args.hid, n_kernels=args.n_kernels,
        neighbourhood_size=args.neighbourhood_size, n_obj=args.n_obj,
        dropout=args.dropout, compute_dtype=args.compute_dtype)
    tcfg = TrainConfig(
        lr=args.lr, epochs=args.ep, batch_size=args.bsize, eval_interval=0,
        seed=args.seed, save_dir=args.save_dir, log_interval=40,
        adam_mu_dtype=mu_dtype, adam_nu_dtype=nu_dtype,
        num_devices=args.num_devices)
    return mcfg, tcfg


@dataclasses.dataclass
class Cell:
    """One grid cell's outcome: the CSV rows, the validation accuracy (%)
    and answers ([{question_id, answer}]), the checkpoint, the training
    steps' ``StepTimer`` summary and the evaluation's questions/s."""

    neighbors: int
    kernels: int
    rows: List[str]
    acc: float
    result: List[dict]
    path: str
    step_times: Dict[str, float]
    eval_questions_per_s: float


def train_one_config(args, train_ds, val_ds, ckpt_prefix: str,
                     shared=None) -> Cell:
    """Train a fresh model on the current cell's flags, evaluate it on
    val and save its checkpoint (rank 0). ``shared`` is (mesh, train
    cache, val cache) built once by the grid; without it ``fit`` and
    ``evaluate`` build their own."""
    mesh, cache, val_cache = (shared if shared
                              else (None, loop._UNSET, loop._UNSET))
    mcfg, tcfg = make_configs(args)
    timer = StepTimer(warmup=3, batch_size=args.bsize)
    model, optimizer, _ = loop.fit(tcfg, mcfg, train_ds, device=args.device,
                                   cache=cache, val_cache=val_cache,
                                   step_timer=timer, mesh=mesh)

    print("Infer", flush=True)
    t0 = time.perf_counter()
    acc, result, _ = loop.evaluate(model, val_ds, args.bsize,
                                   result_path=None, cache=val_cache,
                                   train_cfg=tcfg, device=args.device,
                                   mesh=mesh)
    eval_s = time.perf_counter() - t0
    # question_id -> dataset row: MIMIC's ids are global csv rows
    # (offset by the train split, gappy where images were filtered)
    qid_to_row = {int(r["question_id"]): i for i, r in enumerate(val_ds.vqa)}
    rows = []
    for r in result:
        row = val_ds.vqa[qid_to_row[int(r["question_id"])]]
        rows.append(f"{row['image_id']},{row['question']},"
                    f"{r['answer']},{row.get('answer', '')}")

    path = os.path.join(args.save_dir,
                        f"{ckpt_prefix}_{args.n_obj}_{args.n_kernels}_"
                        f"{args.neighbourhood_size}_{acc:.2f}.pt")
    if multihost.is_primary():
        os.makedirs(args.save_dir, exist_ok=True)
        save_checkpoint(path, model, optimizer, step=adam_step(optimizer),
                        epoch=args.ep, model_cfg=model.cfg, train_cfg=tcfg,
                        extra={"accuracy": acc})
    step_times = timer.summary()
    print(f"cell timing: steps {json.dumps(step_times)}; evaluate "
          f"{len(result) / eval_s:.1f} questions/s", flush=True)
    return Cell(args.neighbourhood_size, args.n_kernels, rows, acc, result,
                path, step_times, len(result) / eval_s)


def grid_search_main(args, parser, unparsed, *, dataset_name: str,
                     ckpt_prefix: str, argv=None) -> Optional[List[Cell]]:
    """The grid over ``--neighbors_list`` x ``--kernels_list`` (cells
    with more neighbours or kernels than ``--n_obj`` skipped); returns
    the cells, or None when ``--train`` is off (help printed) or when
    this process only started the ranks of ``--num_devices`` (``argv``,
    default ``sys.argv[1:]``, is what they run)."""
    if len(unparsed) != 0:
        raise SystemExit("Unknown argument: {}".format(unparsed))
    if not args.train:
        parser.print_help()
        return None
    n = multihost.ranks_to_spawn(args.num_devices, args.device)
    if n:
        multihost.spawn(f"vqa_project_tpu_torch.cli.run_{dataset_name}:main",
                        sys.argv[1:] if argv is None else argv, n)
        return None
    started = multihost.maybe_initialize_distributed(args.device)
    try:
        return _grid(args, dataset_name, ckpt_prefix)
    finally:
        if started:
            multihost.shutdown()


def _grid(args, dataset_name: str, ckpt_prefix: str) -> List[Cell]:
    train_ds, val_ds = _load_datasets(args, dataset_name)
    # one mesh and, as every cell trains at the same n_obj and dtype, one
    # cache per store for the whole grid
    _, tcfg0 = make_configs(args)
    mesh = make_mesh(args.num_devices, args.device)
    cache = loop.make_feature_cache(train_ds, tcfg0, args.compute_dtype,
                                    args.device, mesh)
    val_cache = (cache if loop._same_store(val_ds.store, train_ds.store)
                 else loop.make_feature_cache(val_ds, tcfg0,
                                              args.compute_dtype,
                                              args.device, mesh))

    cells: List[Cell] = []
    best_acc = 0.0
    grid_path = f"grid_search_nodes_{args.n_obj}.txt"
    # rank 0 writes the grid's files; the file handle is the rank guard
    primary = multihost.is_primary()
    if primary:
        os.makedirs(args.plot_dir, exist_ok=True)
    with (open(grid_path, "w") if primary
          else contextlib.nullcontext()) as f:
        for neighbors in args.neighbors_list:
            for kernels in args.kernels_list:
                if kernels > args.n_obj or neighbors > args.n_obj:
                    continue
                args.n_kernels = kernels
                args.neighbourhood_size = neighbors
                print(args, flush=True)
                cell = train_one_config(args, train_ds, val_ds, ckpt_prefix,
                                        shared=(mesh, cache, val_cache))
                # the cell's model and optimizer are gone with its frame;
                # collect them before the next cell allocates its own
                gc.collect()
                line = (f"neighbors: {neighbors}, kernels: {kernels}, "
                        f"Validation acc: {cell.acc:.3f} %\n")
                print(line, end="", flush=True)
                if f:
                    f.write(line)
                    f.flush()
                better = cell.acc > best_acc
                best_acc = max(best_acc, cell.acc)
                if better and primary:
                    csv_path = os.path.join(
                        args.plot_dir,
                        f"{ckpt_prefix}_{args.n_obj}_{cell.acc:.2f}.csv")
                    with open(csv_path, "w") as f2:
                        f2.write("image_id,question,prediction,answer\n")
                        for row in cell.rows:
                            f2.write(row + "\n")
                cells.append(cell)
    print(f"grid search done; best acc {best_acc:.3f} % -> {grid_path}",
          flush=True)
    return cells


def _synthetic_knobs(args) -> dict:
    return dict(n_obj=args.n_obj, n_images=args.synthetic_images,
                n_questions=args.synthetic_questions,
                feat_dim=args.synthetic_feat_dim,
                q_vocab=args.synthetic_vocab,
                n_answers=args.synthetic_answers)


def _load_datasets(args, dataset_name: str):
    """(train, val) datasets; with ``--synthetic`` the set is generated
    first and ``args.data_dir`` pointed at it."""
    generators = {"imageclef": generate_synthetic_imageclef,
                  "mimic": generate_synthetic_mimic}
    if dataset_name not in generators:
        raise ValueError(dataset_name)
    if args.synthetic:
        sdir = os.path.join(args.data_dir, f"synthetic_{dataset_name}")
        knobs = _synthetic_knobs(args)
        ensure_synthetic(
            sdir, knobs, lambda: generators[dataset_name](sdir, **knobs))
        args.data_dir = sdir
    # rank 0 packs the feature stores on first use, the others then read
    if dataset_name == "imageclef":
        # train and val read the one imageclef json (as the reference)
        train_ds = multihost.primary_first(lambda: GraphVQADataset.imageclef(
            args.data_dir, "train", args.emb, args.n_obj))
        return train_ds, train_ds
    return multihost.primary_first(lambda: (
        GraphVQADataset.mimic(args.data_dir, "train", args.emb, args.n_obj),
        GraphVQADataset.mimic(args.data_dir, "val", args.emb, args.n_obj)))
