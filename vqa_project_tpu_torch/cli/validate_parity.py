"""Evaluate a reference PyTorch checkpoint with the port.

    python -m vqa_project_tpu_torch.cli.validate_parity \
        --model_path save/vqa_36_8_16_XX.pt --data_dir ./data --split val

Counterpart of ``vqa_project_tpu/cli/validate_parity.py``: loads the
reference's ``.pt`` (``load_reference_checkpoint``), evaluates the split
with the adjacencies collected, writes ``result.json`` to the working
directory and prints the same JSON keys: the accuracy beside the
reference's published 66.2%, the question count, the number of distinct
answers predicted and two statistics of the learned adjacencies. Left
out: ``--num_devices`` (one card). Added: ``--device`` (default
``cuda``). The model computes in the default dtype, bfloat16, as the
JAX CLI's does.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description="torch-checkpoint parity eval")
    p.add_argument("--model_path", type=str, required=True,
                   help="reference torch .pt state_dict")
    p.add_argument("--data_dir", type=str, default="./data")
    p.add_argument("--split", type=str, default="val")
    p.add_argument("--bsize", type=int, default=64)
    p.add_argument("--emb", type=int, default=300)
    p.add_argument("--hid", type=int, default=1024)
    p.add_argument("--n_kernels", type=int, default=8)
    p.add_argument("--neighbourhood_size", type=int, default=16)
    p.add_argument("--n_obj", type=int, default=36)
    p.add_argument("--combined_dim", type=int, default=512)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cpu runs the plain PyTorch "
                        "versions of the kernels)")
    args, unparsed = p.parse_known_args(argv)
    if unparsed:
        raise SystemExit(f"Unknown argument: {unparsed}")

    import numpy as np

    from vqa_project_tpu_torch.config import ModelConfig
    from vqa_project_tpu_torch.data import GraphVQADataset
    from vqa_project_tpu_torch.models import load_reference_checkpoint
    from vqa_project_tpu_torch.train.loop import build_model, evaluate

    print(f"importing torch checkpoint {args.model_path}")
    state_dict = load_reference_checkpoint(args.model_path)

    ds = GraphVQADataset.vqa2(args.data_dir, args.split, args.emb,
                              args.n_obj)
    mcfg = ModelConfig(
        emb_dim=args.emb, hid_dim=args.hid, n_kernels=args.n_kernels,
        neighbourhood_size=args.neighbourhood_size, n_obj=args.n_obj,
        combined_dim=args.combined_dim, dropout=0.0)
    model = build_model(mcfg, ds, device=args.device)
    model.load_state_dict(state_dict)

    acc, result, adjacencies = evaluate(
        model, ds, args.bsize, result_path="result.json",
        collect_adjacency=True, device=args.device)
    adjacencies = np.stack([adjacencies[i] for i in sorted(adjacencies)])
    preds = [r["answer"] for r in result]
    print(json.dumps({
        "split": args.split,
        "vqa_accuracy_pct": round(acc, 2),
        "reference_published_pct": 66.2,
        "n_questions": ds.n_questions,
        "unique_answers_predicted": len(set(preds)),
        "adjacency_mean_abs": float(np.abs(adjacencies).mean()),
        "adjacency_row_sum_std": float(adjacencies.sum(-1).std()),
    }, indent=2))


if __name__ == "__main__":
    main()
