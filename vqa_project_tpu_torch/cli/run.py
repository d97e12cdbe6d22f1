"""VQA v2 CLI: train / trainval / eval / test, on the card.

    python -m vqa_project_tpu_torch.cli.run --train --data_dir ./data
    python -m vqa_project_tpu_torch.cli.run --eval --model_path m.ckpt

Counterpart of ``vqa_project_tpu/cli/run.py`` with its flag names and
defaults, reading the same artifacts (``GraphVQADataset.vqa2``) or, with
``--synthetic``, generating them under ``<data_dir>/synthetic`` (again
when a ``--synthetic_*`` knob changes). ``--adam_mu_dtype``,
``--adam_nu_dtype``, ``--grad_reduce_dtype`` and ``--fast_math``
resolve as in JAX (``resolve_dtype_knobs``, ``resolve_grad_reduce``).
Left out: ``--tp`` (tensor parallelism is not ported yet) and the
TPU-only ``--pallas``, ``--no_pallas`` and ``--pallas_gather``: passing
any of them, or any other unknown argument, raises SystemExit.
Added: ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch
versions of the kernels).

Data parallelism: ``--bsize`` is the global batch, split over the
ranks. ``--num_devices N`` (default: every visible card) starts N ranks,
rank i on card i, joined by NCCL (gloo with ``--device cpu``); a count
above the visible cards raises. Under ``torchrun --nproc_per_node N -m
vqa_project_tpu_torch.cli.run ...`` each process is a rank already.
Rank 0 alone generates the synthetic set (every rank waits at a
barrier), packs the feature stores first and writes checkpoints,
``metrics.jsonl`` and ``result.json``.

- ``--train``: fit on the train split with a mini-validation on val
  every ``--eval_interval`` steps, ``{save_dir}/{name}_{epoch}.ckpt``
  after each epoch and ``{save_dir}/metrics.jsonl``; ``--model_path``
  resumes (a port checkpoint, a reference ``.pt`` or a JAX-package
  msgpack checkpoint).
- ``--trainval``: fit on train + val and save
  ``{save_dir}/vqa_{n_obj}_{n_kernels}_{neighbourhood_size}_{acc:.2f}.pt``
  (a port checkpoint whose ``state_dict`` has the reference's names).
- ``--eval`` / ``--test``: load ``--model_path`` (any of those three
  kinds; a reference ``.pt`` bare or full dict), write the EvalAI
  ``result.json`` to the working directory, and for ``--eval`` print the
  val accuracy.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

from vqa_project_tpu_torch.config import ModelConfig, TrainConfig
from vqa_project_tpu_torch.data import GraphVQADataset, write_synthetic_vqa
from vqa_project_tpu_torch.parallel import multihost


def input_args(argv=None):
    """(args, parser, unparsed arguments)."""
    parser = argparse.ArgumentParser(
        description="Conditional Graph Convolutions for VQA (PyTorch/CUDA)")
    parser.add_argument("--train", action="store_true", default=False,
                        help="set this to training mode.")
    parser.add_argument("--trainval", action="store_true", default=False,
                        help="set this to train+val mode.")
    parser.add_argument("--eval", action="store_true", default=False,
                        help="set this to evaluation mode.")
    parser.add_argument("--test", action="store_true", default=False,
                        help="set this to test mode.")
    parser.add_argument("--lr", metavar="", type=float, default=1e-4,
                        help="initial learning rate")
    parser.add_argument("--ep", metavar="", type=int, default=40,
                        help="number of epochs.")
    parser.add_argument("--bsize", metavar="", type=int, default=64,
                        help="batch size.")
    parser.add_argument("--n_kernels", type=int, default=8,
                        help="number of Gaussian kernels.")
    parser.add_argument("--hid", metavar="", type=int, default=1024,
                        help="hidden dimension")
    parser.add_argument("--emb", metavar="", type=int, default=300,
                        help="question embedding dimension")
    parser.add_argument("--neighbourhood_size", type=int, default=16,
                        help="number of graph neighbours to consider")
    parser.add_argument("--n_obj", type=int, default=36,
                        help="number of boxes per image")
    parser.add_argument("--data_dir", metavar="", type=str, default="./data",
                        help="path to data directory")
    parser.add_argument("--save_dir", type=str, default="./save")
    parser.add_argument("--plot_dir", type=str, default="./figures")
    parser.add_argument("--log_interval", type=int, default=40)
    parser.add_argument("--eval_interval", type=int, default=400)
    parser.add_argument("--name", metavar="", type=str, default="model",
                        help="model name")
    parser.add_argument("--dropout", metavar="", type=float, default=0.5,
                        help="dropout probability")
    parser.add_argument("--model_path", type=str, default=None,
                        help="trained model path.")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="data-parallel ranks, one per card (default: "
                             "every visible card; with --device cpu, 1)")
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])
    add_adam_dtype_args(parser)
    parser.add_argument("--grad_reduce_dtype", type=str, default=None,
                        choices=["float32", "bfloat16"],
                        help="dtype of the data-parallel gradient "
                             "all-reduce (bfloat16 halves its bytes; "
                             "float32 = exact up to the order of the sum; "
                             "default float32, or bfloat16 under "
                             "--fast_math)")
    parser.add_argument("--feature_cache_dtype", type=str, default="auto",
                        choices=["auto", "bfloat16", "float32", "int8"],
                        help="dtype of the feature table on the card: "
                             "auto follows --compute_dtype; int8 "
                             "row-quantizes it")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cpu runs the plain PyTorch "
                             "versions of the kernels)")
    add_synthetic_args(parser)
    parser.add_argument("--seed", type=int, default=1000)
    args, unparsed = parser.parse_known_args(argv)
    return args, parser, unparsed


def add_adam_dtype_args(parser) -> None:
    """--adam_mu_dtype, --adam_nu_dtype and --fast_math (the JAX CLI's
    flags less --grad_reduce_dtype)."""
    parser.add_argument("--adam_mu_dtype", type=str, default=None,
                        choices=["float32", "bfloat16"],
                        help="storage dtype of Adam's first moment "
                             "(bfloat16 halves its memory traffic; "
                             "float32 = exact Adam; default float32, or "
                             "bfloat16 under --fast_math)")
    parser.add_argument("--adam_nu_dtype", type=str, default=None,
                        choices=["float32", "bfloat16"],
                        help="storage dtype of Adam's second moment "
                             "(update math stays f32; default float32, or "
                             "bfloat16 under --fast_math)")
    parser.add_argument("--fast_math", action="store_true",
                        help="preset: every Adam moment dtype left unset "
                             "becomes bfloat16; an explicit "
                             "--adam_*_dtype wins over it")


def resolve_dtype_knobs(args):
    """(adam_mu_dtype, adam_nu_dtype): the explicit flag, else bfloat16
    under --fast_math, else float32 (the JAX CLI's rule for these two)."""
    fast = getattr(args, "fast_math", False)
    mu = args.adam_mu_dtype or ("bfloat16" if fast else "float32")
    nu = args.adam_nu_dtype or ("bfloat16" if fast else "float32")
    return mu, nu


def resolve_grad_reduce(args) -> str:
    """grad_reduce_dtype: the explicit flag, else bfloat16 under
    --fast_math, else float32 (the JAX CLI's third knob at tp = 1; fit
    degrades bfloat16 to float32 for a sharded feature cache)."""
    return args.grad_reduce_dtype or (
        "bfloat16" if getattr(args, "fast_math", False) else "float32")


def add_synthetic_args(parser) -> None:
    """The --synthetic flag group (``synthetic_dir`` reads every knob)."""
    parser.add_argument("--synthetic", action="store_true",
                        help="run on a generated synthetic mini-dataset")
    parser.add_argument("--synthetic_questions", type=int, default=96,
                        help="QA pairs in the synthetic set (changing any "
                             "--synthetic_* knob regenerates the dataset "
                             "in place on the next run)")
    parser.add_argument("--synthetic_images", type=int, default=24)
    parser.add_argument("--synthetic_feat_dim", type=int, default=64)
    parser.add_argument("--synthetic_vocab", type=int, default=40)
    parser.add_argument("--synthetic_answers", type=int, default=12,
                        help="answer-vocab size of the synthetic set "
                             "(3000 = the real VQA v2 head)")
    parser.add_argument("--synthetic_classes", type=int, default=0,
                        help="distinct image classes (0 = answers/2)")
    parser.add_argument("--synthetic_encoding", type=str,
                        default="scalar", choices=["scalar", "binary"],
                        help="how the image class is written into the "
                             "features (binary scales to many classes)")


def make_configs(args):
    mu_dtype, nu_dtype = resolve_dtype_knobs(args)
    mcfg = ModelConfig(
        emb_dim=args.emb, hid_dim=args.hid, n_kernels=args.n_kernels,
        neighbourhood_size=args.neighbourhood_size, n_obj=args.n_obj,
        dropout=args.dropout, compute_dtype=args.compute_dtype)
    tcfg = TrainConfig(
        lr=args.lr, epochs=args.ep, batch_size=args.bsize,
        log_interval=args.log_interval, eval_interval=args.eval_interval,
        save_dir=args.save_dir, name=args.name, seed=args.seed,
        feature_cache_dtype=args.feature_cache_dtype,
        adam_mu_dtype=mu_dtype, adam_nu_dtype=nu_dtype,
        num_devices=args.num_devices,
        grad_reduce_dtype=resolve_grad_reduce(args))
    return mcfg, tcfg


def synthetic_dir(args) -> str:
    """``<data_dir>/synthetic``, (re)generated unless its
    ``fingerprint.json`` holds exactly these --synthetic_* knobs (the
    JAX CLI's rule and file, so either CLI reuses the other's set)."""
    sdir = os.path.join(args.data_dir, "synthetic")
    knobs = dict(n_obj=args.n_obj,
                 n_questions=args.synthetic_questions,
                 n_images=args.synthetic_images,
                 feat_dim=args.synthetic_feat_dim,
                 q_vocab=args.synthetic_vocab,
                 n_answers=args.synthetic_answers,
                 n_classes=args.synthetic_classes,
                 class_encoding=args.synthetic_encoding)
    ensure_synthetic(sdir, knobs, lambda: write_synthetic_vqa(
        sdir, with_test=True, **knobs))
    return sdir


def ensure_synthetic(sdir: str, knobs: dict, generate) -> None:
    """Run ``generate()`` to (re)write the synthetic set in ``sdir``
    unless its ``fingerprint.json`` holds exactly ``knobs``: the knobs
    are the dataset, so a changed one never trains on a stale set.

    Over several ranks rank 0 alone reads the fingerprint and generates,
    and every rank then reaches one barrier, whatever rank 0 decided (a
    rank that read the fingerprint itself could take another branch);
    the others then read rank 0's files, so ``sdir`` must be on a file
    system that every rank shares."""
    fp_path = os.path.join(sdir, "fingerprint.json")
    if multihost.is_primary():
        on_disk = None
        if os.path.exists(fp_path):
            with open(fp_path) as f:
                on_disk = json.load(f)
        if on_disk != knobs:
            if os.path.exists(sdir):
                # wholly generated: a smaller set must leave nothing behind
                print(f"Synthetic knobs changed vs {fp_path}: regenerating "
                      "the dataset", flush=True)
                shutil.rmtree(sdir)
            generate()
            tmp = fp_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(knobs, f)
            os.replace(tmp, fp_path)   # a crash leaves no half fingerprint
    multihost.barrier()
    if not os.path.exists(fp_path):
        raise FileNotFoundError(
            f"rank {multihost.rank()}: no synthetic set at {sdir} after "
            "rank 0 generated it; --data_dir must be shared by every rank")


def _dataset(args, split):
    data_dir = synthetic_dir(args) if args.synthetic else args.data_dir
    # rank 0 packs the feature store on first use, the others then read it
    return multihost.primary_first(lambda: GraphVQADataset.vqa2(
        data_dir, split, args.emb, args.n_obj))


def train(args):
    """Train-split mode with periodic mini-validation; returns fit's
    (model, optimizer, epoch accuracy)."""
    from vqa_project_tpu_torch.train.loop import fit

    mcfg, tcfg = make_configs(args)
    print("Loading data", flush=True)
    train_ds = _dataset(args, "train")
    val_ds = _dataset(args, "val")
    _print_params(train_ds, args)
    return fit(tcfg, mcfg, train_ds, val_ds, device=args.device,
               resume_path=args.model_path, save_every_epoch=True,
               jsonl_path=os.path.join(args.save_dir, "metrics.jsonl"))


def trainval(args):
    """Train on train + val and save the named checkpoint; returns
    (model, its path, epoch accuracy)."""
    from vqa_project_tpu_torch.train.loop import fit
    from vqa_project_tpu_torch.train.state import adam_step, save_checkpoint

    mcfg, tcfg = make_configs(args)
    print("Loading data", flush=True)
    ds = _dataset(args, "trainval")
    _print_params(ds, args)
    model, optimizer, acc = fit(
        tcfg, mcfg, ds, device=args.device, resume_path=args.model_path,
        jsonl_path=os.path.join(args.save_dir, "metrics.jsonl"))
    name = (f"vqa_{args.n_obj}_{args.n_kernels}_"
            f"{args.neighbourhood_size}_{acc:.2f}.pt")
    path = os.path.join(args.save_dir, name)
    if multihost.is_primary():
        os.makedirs(args.save_dir, exist_ok=True)
        save_checkpoint(path, model, optimizer, step=adam_step(optimizer),
                        epoch=tcfg.epochs, model_cfg=model.cfg,
                        train_cfg=tcfg,
                        extra={"accuracy": acc, "config": vars(args)})
        print(f"Saved {name}", flush=True)
    return model, path, acc


def eval_model(args):
    """Validation accuracy and result.json; returns the accuracy."""
    acc = _run_eval(args, split="val")
    print("accuracy: {} %".format(acc), flush=True)
    print("Validation done", flush=True)
    return acc


def test(args):
    """The test split's result.json for EvalAI: its questions carry no
    answers, so no accuracy is computed or printed."""
    _run_eval(args, split="test")
    print("Testing done", flush=True)


def _run_eval(args, split):
    from vqa_project_tpu_torch.train.loop import build_model, evaluate
    from vqa_project_tpu_torch.train.state import load_checkpoint

    if not (args.model_path and os.path.isfile(args.model_path)):
        raise SystemExit("Need to provide model path.")
    print("Resuming from checkpoint %s" % args.model_path, flush=True)
    mcfg, tcfg = make_configs(args)
    print("Loading data", flush=True)
    ds = _dataset(args, split)
    _print_params(ds, args)
    model = build_model(mcfg, ds, device=args.device, seed=args.seed)
    load_checkpoint(args.model_path, model)
    acc, _, _ = evaluate(model, ds, args.bsize, result_path="result.json",
                         train_cfg=tcfg, device=args.device)
    return acc


def _print_params(ds, args):
    print("Parameters:\n\t"
          "vocab size: %d\n\tembedding dim: %d\n\tfeature dim: %d"
          "\n\thidden dim: %d\n\toutput dim: %d" % (
              ds.q_words, args.emb, ds.feat_dim, args.hid, ds.n_answers),
          flush=True)


def main(argv=None) -> None:
    args, parser, unparsed = input_args(argv)
    if len(unparsed) != 0:
        raise SystemExit("Unknown argument: {}".format(unparsed))
    n = multihost.ranks_to_spawn(args.num_devices, args.device)
    if n:
        multihost.spawn("vqa_project_tpu_torch.cli.run:main",
                        sys.argv[1:] if argv is None else argv, n)
        return
    started = multihost.maybe_initialize_distributed(args.device)
    try:
        _run_modes(args, parser)
    finally:
        if started:
            multihost.shutdown()


def _run_modes(args, parser) -> None:
    ran = False
    if args.train:
        train(args)
        ran = True
    if args.trainval:
        trainval(args)
        ran = True
    if args.eval:
        eval_model(args)
        ran = True
    if args.test:
        test(args)
        ran = True
    if not ran:
        parser.print_help()


if __name__ == "__main__":
    main()
