"""Set-up shared by the drivers: the cell's inputs, the program's model
configuration, device synchronization."""

from __future__ import annotations

import torch

from portbench.harness.data import feature_table, question_table


def forever(loader):
    while True:
        yield from loader


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def model_config(m, **changes):
    from vqa_project_tpu_torch.config import ModelConfig
    return ModelConfig(**{k: m[k] for k in (
        "vocab_size", "emb_dim", "feat_dim", "hid_dim", "out_dim",
        "combined_dim", "n_kernels", "neighbourhood_size", "n_obj",
        "dropout", "max_qlen", "compute_dtype")}, **changes)


def program_model(m, weights, device):
    """The program's model at the configuration's widths holding
    ``weights``."""
    from vqa_project_tpu_torch.models.graph_vqa import GraphVQAModel
    model = GraphVQAModel(model_config(m), device=device, seed=0)
    model.load_state_dict(weights)
    return model


def inputs(ctx):
    """The cell's inputs from its seed: the device table, the question
    table and the sizes."""
    c, m, wl = ctx.cell, ctx.cell.model, ctx.cell.workload
    split = c.config["data"][wl["split"]]
    n_img, n_q = split["images"], split["questions"]
    feats, boxes = feature_table(n_img, m["n_obj"], m["feat_dim"] - 4,
                                 ctx.seed, ctx.device)
    table = question_table(n_q, n_img, m["vocab_size"], m["out_dim"] - 1,
                           m["max_qlen"], wl["qlen_pmf"], ctx.seed)
    return feats, boxes, table


class no_tf32:
    """TF32 off for float32 products (the reference's)."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
