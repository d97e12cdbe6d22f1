"""Interpretability-plot CLI.

    python -m vqa_project_tpu_torch.cli.plot --model_path m.ckpt

Counterpart of ``vqa_project_tpu/cli/plot.py`` (the reference's plot.py
entry) with its flags and defaults: load a checkpoint (the port's
``.ckpt``, a reference ``.pt`` or a JAX msgpack, sniffed by
``train.state.load_checkpoint``), run the model over ``--n_batches``
val batches on the card, then write ``adj_{question_id}.jpg`` figures,
``infer_predictions.csv``, ``adjacencies.npz`` and ``summary.json`` to
``--plot_dir``; ``--question`` renders one (question, image) pair to
``given_question.jpg`` instead. ``--synthetic`` follows the JAX rule:
write the synthetic set with raw JPEGs when ``train_q_dict.p`` is
missing from ``<data_dir>/synthetic``, else backfill its JPEGs. Left
out: ``--num_devices``; added: ``--device`` (default ``cuda``; ``cpu``
runs the plain PyTorch versions of the kernels). Rendering and the
synthetic JPEGs need matplotlib; the model's half does not.
"""

from __future__ import annotations

import argparse
import os

from vqa_project_tpu_torch.config import ModelConfig, resolve_device
from vqa_project_tpu_torch.data import GraphVQADataset
from vqa_project_tpu_torch.data.synthetic import (ensure_synthetic_images,
                                                  write_synthetic_vqa)
from vqa_project_tpu_torch.train.loop import build_model
from vqa_project_tpu_torch.train.state import load_checkpoint
from vqa_project_tpu_torch.viz import (plot_given_question,
                                       visualize_checkpoint)


def input_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Plot learned graph structures (PyTorch/CUDA)")
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--data_dir", type=str, default="./data")
    parser.add_argument("--plot_dir", type=str, default="./figures")
    parser.add_argument("--image_dir", type=str, default=None,
                        help="directory of raw images (e.g. coco/val2014); "
                             "figures are then drawn over the photograph")
    parser.add_argument("--question", type=str, default=None,
                        help="render a single (question, image_id) figure "
                             "instead of the batch sweep (plot_given_fig)")
    parser.add_argument("--image_id", type=str, default=None,
                        help="disambiguate --question by image id")
    parser.add_argument("--bsize", type=int, default=32)
    parser.add_argument("--n_batches", type=int, default=4)
    parser.add_argument("--top_nodes", type=int, default=7)
    parser.add_argument("--split", type=str, default="val")
    parser.add_argument("--emb", type=int, default=300)
    parser.add_argument("--hid", type=int, default=1024)
    parser.add_argument("--n_kernels", type=int, default=8)
    parser.add_argument("--neighbourhood_size", type=int, default=16)
    parser.add_argument("--n_obj", type=int, default=36)
    parser.add_argument("--dropout", type=float, default=0.5)
    parser.add_argument("--compute_dtype", type=str, default="bfloat16")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cpu runs the plain PyTorch "
                             "versions of the kernels)")
    parser.add_argument("--synthetic", action="store_true")
    args, unparsed = parser.parse_known_args(argv)
    if unparsed:
        raise SystemExit("Unknown argument: {}".format(unparsed))
    return args


def main(argv=None):
    args = input_args(argv)
    # the card is asked for before anything is written or read
    device = resolve_device(args.device)
    if args.synthetic:
        sdir = os.path.join(args.data_dir, "synthetic")
        if not os.path.exists(os.path.join(sdir, "train_q_dict.p")):
            write_synthetic_vqa(sdir, with_test=True, n_obj=args.n_obj,
                                with_images=True)
        else:
            ensure_synthetic_images(sdir)
        data_dir = sdir
        if args.image_dir is None:
            args.image_dir = os.path.join(sdir, "images")
    else:
        data_dir = args.data_dir

    ds = GraphVQADataset.vqa2(data_dir, args.split, args.emb, args.n_obj)
    mcfg = ModelConfig(
        emb_dim=args.emb, hid_dim=args.hid, n_kernels=args.n_kernels,
        neighbourhood_size=args.neighbourhood_size, n_obj=args.n_obj,
        dropout=args.dropout, compute_dtype=args.compute_dtype)
    model = build_model(mcfg, ds, device=device)
    load_checkpoint(args.model_path, model)

    if args.question:
        os.makedirs(args.plot_dir, exist_ok=True)
        out = os.path.join(args.plot_dir, "given_question.jpg")
        plot_given_question(
            model, ds, args.question, image_id=args.image_id, path=out,
            top_nodes=args.top_nodes, image_dir=args.image_dir)
        print(f"figure written to {out}")
        return

    out = visualize_checkpoint(
        model, ds, args.plot_dir, batch_size=args.bsize,
        n_batches=args.n_batches, top_nodes=args.top_nodes,
        image_dir=args.image_dir)
    print(f"figures written to {out}")


if __name__ == "__main__":
    main()
