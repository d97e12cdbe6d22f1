"""Synthetic medical-VQA sets (ImageCLEF / MIMIC artifacts on disk).

Copy of ``vqa_project_tpu/data/synthetic_medical.py``: the same numpy
draws in the same order from the same seed, so both packages write the
same arrays, json rows and vocabulary pickles. They are the artifacts
``GraphVQADataset.imageclef`` and ``.mimic`` read: imageclef_* as one
json for train and val, answers as a {answer: votes} dict and image ids
keyed '<id>.jpg'; mimic_* per split (vocabularies, zarr stores, json),
answers as [answer, votes] lists. The image class is written into
feature column 0 and decides the answer with the question type, so the
task is learnable.
"""

from __future__ import annotations

import json
import os

import numpy as np

from vqa_project_tpu_torch.data.datasets import write_sizes_csv
from vqa_project_tpu_torch.data.vocab import save_vocab
from vqa_project_tpu_torch.data.zarr_store import ZarrWriter


def _write_images(data_dir, prefix, ids, n_obj, feat_dim, rng, img_class):
    feats = ZarrWriter(os.path.join(data_dir, f"{prefix}features.zarr"))
    boxes = ZarrWriter(os.path.join(data_dir, f"{prefix}boxes.zarr"))
    sizes = {}
    for iid in ids:
        w, h = int(rng.integers(300, 640)), int(rng.integers(300, 640))
        f = rng.standard_normal((n_obj, feat_dim)).astype(np.float32)
        f[:, 0] = img_class[iid]
        xy1 = rng.uniform(0, 0.5, size=(n_obj, 2))
        wh = rng.uniform(0.05, 0.45, size=(n_obj, 2))
        b = np.concatenate([xy1, xy1 + wh], axis=-1).astype(np.float32)
        b[:, [0, 2]] *= w
        b[:, [1, 3]] *= h
        feats.create_dataset(iid, f)
        boxes.create_dataset(iid, b)
        sizes[iid] = (w, h)
    write_sizes_csv(os.path.join(data_dir, f"{prefix}image_size.csv"),
                    sizes)


def generate_synthetic_imageclef(
    data_dir: str, n_images: int = 12, n_questions: int = 64,
    n_obj: int = 51, feat_dim: int = 32, q_vocab: int = 24,
    n_answers: int = 8, seed: int = 1000) -> str:
    """Write an ImageCLEF-VQA-Med set of ``n_images`` images of ``n_obj``
    boxes with ``feat_dim`` features and ``n_questions`` questions under
    ``data_dir``; returns ``data_dir``."""
    rng = np.random.default_rng(seed)
    os.makedirs(data_dir, exist_ok=True)

    base_ids = [f"clefimg{i}" for i in range(n_images)]
    img_class = {f"{b}.jpg": int(rng.integers(0, n_answers // 2))
                 for b in base_ids}
    # ImageCLEF image ids are keyed '<id>.jpg' (torch_dataset.py:269)
    _write_images(data_dir, "imageclef_", [f"{b}.jpg" for b in base_ids],
                  n_obj, feat_dim, rng, img_class)

    q_words = [f"cword{i}" for i in range(q_vocab)]
    save_vocab(os.path.join(data_dir, "imageclef_q_dict.p"),
               {i + 1: w for i, w in enumerate(q_words)},
               {w: i + 1 for i, w in enumerate(q_words)})
    a_words = [f"cans{i}" for i in range(n_answers)]
    save_vocab(os.path.join(data_dir, "imageclef_a_dict.p"),
               {i: w for i, w in enumerate(a_words)},
               {w: i for i, w in enumerate(a_words)})

    rows = []
    for j in range(n_questions):
        base = base_ids[int(rng.integers(0, n_images))]
        qlen = int(rng.integers(3, 9))
        toks = [q_words[int(rng.integers(0, q_vocab))] for _ in range(qlen)]
        qtype = int(rng.integers(0, 2))
        toks[0] = q_words[qtype]
        ans = a_words[img_class[f"{base}.jpg"] * 2 + qtype]
        rows.append({
            "question": " ".join(toks) + "?",
            "question_id": j,
            "image_id": base,                  # suffixed '.jpg' by adapter
            "question_toked": toks,
            "answer": ans,
            "answers": {ans: 10},              # dict form (torch_dataset:259)
            "answers_w_scores": [[ans, 1.0]],
        })
    with open(os.path.join(data_dir, "vqa_imageclef_final.json"), "w") as f:
        json.dump(rows, f)
    return data_dir


def generate_synthetic_mimic(
    data_dir: str, n_images: int = 12, n_questions: int = 64,
    n_obj: int = 51, feat_dim: int = 32, q_vocab: int = 24,
    n_answers: int = 8, seed: int = 1000) -> str:
    """Write a MIMIC-CXR set, a train and a val split of ``n_images``
    images and ``n_questions`` questions each, under ``data_dir``;
    returns ``data_dir``."""
    rng = np.random.default_rng(seed)
    os.makedirs(data_dir, exist_ok=True)

    for split in ("train", "val"):
        ids = [f"mimic_{split}_{i}" for i in range(n_images)]
        img_class = {i: int(rng.integers(0, n_answers // 2)) for i in ids}
        _write_images(data_dir, f"mimic_{split}_", ids, n_obj, feat_dim,
                      rng, img_class)

        q_words = [f"mword{i}" for i in range(q_vocab)]
        save_vocab(os.path.join(data_dir, f"mimic_q_{split}_dict.p"),
                   {i + 1: w for i, w in enumerate(q_words)},
                   {w: i + 1 for i, w in enumerate(q_words)})
        a_words = [f"mans{i}" for i in range(n_answers)]
        save_vocab(os.path.join(data_dir, f"mimic_a_{split}_dict.p"),
                   {i: w for i, w in enumerate(a_words)},
                   {w: i for i, w in enumerate(a_words)})

        rows = []
        for j in range(n_questions):
            iid = ids[int(rng.integers(0, n_images))]
            qlen = int(rng.integers(3, 9))
            toks = [q_words[int(rng.integers(0, q_vocab))]
                    for _ in range(qlen)]
            qtype = int(rng.integers(0, 2))
            toks[0] = q_words[qtype]
            ans = a_words[img_class[iid] * 2 + qtype]
            rows.append({
                "question": " ".join(toks) + "?",
                "question_id": j,
                "image_id": iid,
                "question_toked": toks,
                "answer": ans,
                "answers": [[ans, 10]],        # list form (torch_dataset:376)
                "answers_w_scores": [[ans, 1.0]],
            })
        with open(os.path.join(data_dir, f"vqa_mimic_{split}_final.json"),
                  "w") as f:
            json.dump(rows, f)
    return data_dir
