"""One rank of a data-parallel run of the port on the CPU (gloo), and the
launcher that starts the ranks.

    python tests/_torch_dp_child.py <spec.json>

with RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT in the environment
(``launch`` sets them). The spec names a data directory (the synthetic
VQA v2 files) and a list of legs, each run by every rank in order:

- ``fit``: ``train.fit`` with the leg's ModelConfig / TrainConfig
  fields, optionally resumed; rank 0's parameters are saved as
  ``<out>/<name>.pt``;
- ``evaluate``: ``train.evaluate`` of the parameters a fit leg saved,
  writing ``<out>/<name>_rank<r>.json`` (rank 0 only, if right);
- ``step``: one ``train.train_step`` on the first batch of a 2-way
  partition of the questions, whose halves hold unequal valid counts.

Each rank writes ``<out>/rank<r>.json``: per leg, a SHA-256 of its
parameters, the logged windows and accuracies, and the files under the
leg's save_dir.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(spec: dict, out_dir: str, n: int = 2, timeout: float = 300.0):
    """Run ``spec`` on ``n`` gloo ranks; returns their reports in rank
    order. A rank that fails, or a run past ``timeout`` seconds (a hung
    collective), fails the caller's test."""
    from vqa_project_tpu_torch.parallel.multihost import free_port

    os.makedirs(out_dir, exist_ok=True)
    spec = dict(spec, out=out_dir)
    path = os.path.join(out_dir, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(port), WORLD_SIZE=str(n))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), path],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r} (exit {p.returncode}):\n{out}"
              for r, (p, out) in enumerate(zip(procs, outs)) if p.returncode]
    assert not failed, "\n".join(failed)
    reports = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def params_sha(model) -> str:
    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _dataset(spec, split):
    from vqa_project_tpu_torch.data import GraphVQADataset

    return GraphVQADataset.vqa2(spec["data_dir"], split,
                                spec.get("emb_dim", 300), spec["n_obj"],
                                spec["max_qlen"])


def _records(path):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return [json.loads(line) for line in f]


def _files(folder):
    return sorted(os.listdir(folder)) if os.path.isdir(folder) else []


def run_fit(spec, leg, rank):
    import torch

    from vqa_project_tpu_torch.config import ModelConfig, TrainConfig
    from vqa_project_tpu_torch.train import fit

    train_ds = _dataset(spec, leg.get("split", "train"))
    val_ds = _dataset(spec, "val") if leg.get("with_val") else None
    # a folder per rank: rank 0's alone may fill
    save_dir = os.path.join(spec["out"], leg["name"], f"rank{rank}")
    tcfg = TrainConfig(save_dir=save_dir, **leg["train"])
    jsonl = os.path.join(save_dir, "metrics.jsonl")
    model, _, acc = fit(tcfg, ModelConfig(**leg["model"]), train_ds, val_ds,
                        device="cpu", resume_path=leg.get("resume"),
                        save_every_epoch=leg.get("save_every_epoch", False),
                        jsonl_path=jsonl)
    if rank == 0:
        torch.save(model.state_dict(),
                   os.path.join(spec["out"], leg["name"] + ".pt"))
    return {"sha": params_sha(model), "acc": acc,
            "records": _records(jsonl), "files": _files(save_dir)}


def run_evaluate(spec, leg, rank):
    import torch

    from vqa_project_tpu_torch.config import ModelConfig, TrainConfig
    from vqa_project_tpu_torch.train import build_model, evaluate

    ds = _dataset(spec, leg.get("split", "val"))
    model = build_model(ModelConfig(**leg["model"]), ds, device="cpu")
    model.load_state_dict(torch.load(
        os.path.join(spec["out"], leg["weights"] + ".pt"), weights_only=True))
    path = os.path.join(spec["out"], f"{leg['name']}_rank{rank}.json")
    tcfg = TrainConfig(batch_size=leg["batch_size"], **leg.get("train", {}))
    acc, result, adj = evaluate(
        model, ds, leg["batch_size"], result_path=path, train_cfg=tcfg,
        device="cpu", collect_adjacency=leg.get("adjacency", False))
    out = {"acc": acc, "result": result}
    if adj is not None:
        out["adjacency"] = {str(k): v.tolist() for k, v in adj.items()}
    return out


def step_partitions(ds, leg):
    """Question partitions whose rank-1 pool holds the first
    ``leg["rank1_questions"]`` questions only."""
    import numpy as np

    parts = np.zeros(ds.n_questions, np.int32)
    parts[:leg["rank1_questions"]] = 1
    return parts


def run_step(spec, leg, rank):
    """One data-parallel step on a locality batch; rank 0 saves the
    parameters after it and the global batch it stepped on."""
    import numpy as np
    import torch

    from vqa_project_tpu_torch.config import ModelConfig, TrainConfig
    from vqa_project_tpu_torch.data import Batcher
    from vqa_project_tpu_torch.parallel import make_mesh, shard_batch
    from vqa_project_tpu_torch.train import build_model, make_optimizer
    from vqa_project_tpu_torch.train.steps import train_step

    ds = _dataset(spec, "train")
    mesh = make_mesh(None, "cpu")
    model = build_model(ModelConfig(**leg["model"]), ds, device="cpu")
    optimizer, _ = make_optimizer(model, TrainConfig(lr=leg["lr"]), 1)
    init_sha = params_sha(model)
    batch = next(iter(Batcher(ds, leg["batch_size"], shuffle=False,
                              partitions=step_partitions(ds, leg),
                              n_partitions=mesh.world)))
    m = train_step(model, optimizer, None, shard_batch(batch, mesh),
                   mesh=mesh, n_valid=float(batch["mask"].sum()))
    if rank == 0:
        torch.save(model.state_dict(),
                   os.path.join(spec["out"], leg["name"] + ".pt"))
        np.save(os.path.join(spec["out"], leg["name"] + "_mask.npy"),
                batch["mask"])
    return {"init_sha": init_sha, "sha": params_sha(model),
            "loss": float(m["loss"]), "valid": float(m["valid"])}


def main(path):
    import torch

    torch.set_flush_denormal(True)
    from vqa_project_tpu_torch.parallel import multihost

    with open(path) as f:
        spec = json.load(f)
    assert multihost.maybe_initialize_distributed("cpu")
    rank = multihost.rank()
    runs = {"fit": run_fit, "evaluate": run_evaluate, "step": run_step}
    report = {"rank": rank, "world": multihost.world()}
    try:
        for leg in spec["legs"]:
            report[leg["name"]] = runs[leg["kind"]](spec, leg, rank)
    except BaseException:
        # leave at once: the other ranks' next collective then fails
        # instead of waiting for this one
        import traceback

        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    multihost.shutdown()
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    main(sys.argv[1])
