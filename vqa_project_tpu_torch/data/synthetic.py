"""Synthetic VQA dataset, in memory.

Counterpart of ``vqa_project_tpu/data/synthetic.py::
generate_synthetic_vqa``: the same numpy draws in the same order from
the same seed, so the same images, boxes, classes and questions, but
returned as ``GraphVQADataset`` objects instead of zarr groups, size CSV,
vocabulary pickles and QA json on disk. Image rows follow the order the
JAX loader gives them (ids sorted as strings), boxes are normalized by
the image size in float32 as that loader does, and the embeddings are
the loader's no-GloVe ``random_embeddings``.

The task is learnable: the answer is a function of the question's first
token (its type) and of a class written into every region feature of
the image, so training accuracy above chance is a meaningful signal.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from vqa_project_tpu_torch.data.datasets import GraphVQADataset
from vqa_project_tpu_torch.data.store import FeatureStore


def generate_synthetic_vqa(n_images: int = 24, n_questions: int = 96,
                           n_obj: int = 36, feat_dim: int = 64,
                           q_vocab: int = 40, n_answers: int = 12,
                           seed: int = 1000, n_classes: int = 0,
                           class_encoding: str = "scalar",
                           emb_dim: int = 300, max_qlen: int = 16,
                           with_test: bool = False
                           ) -> Dict[str, GraphVQADataset]:
    """Splits "train" (75% of the questions), "val" and "trainval", and
    with ``with_test`` a "test" split: n_questions // 4 unannotated
    questions over the first max(2, n_images // 4) images, with a store
    of its own (as the test2015 features are), drawn after the other
    splits so that their draws are unchanged.

    feat_dim is the region feature width without the 4 box channels;
    n_answers the answer vocabulary (the datasets' n_answers is one more,
    the pad slot). n_classes (default n_answers // 2) image classes each
    own two answers, one per question type; class_encoding "scalar"
    writes the class into channel 0, "binary" writes its bits as +-2
    across the first ceil(log2(n_classes)) channels.
    """
    n_classes = n_classes or n_answers // 2
    if 2 * n_classes > n_answers:
        raise ValueError(
            f"n_answers={n_answers} is too small for n_classes={n_classes}:"
            f" the two question types index answer words up to "
            f"{2 * n_classes - 1}")
    n_bits = max(1, int(np.ceil(np.log2(max(n_classes, 2)))))
    if class_encoding == "binary" and n_bits > feat_dim:
        raise ValueError(f"class_encoding='binary' needs {n_bits} feature "
                         f"channels, feat_dim={feat_dim}")
    rng = np.random.default_rng(seed)

    feats, boxes, img_class = {}, {}, {}
    for i in range(n_images):
        iid = str(100 + i)
        w, h = int(rng.integers(300, 640)), int(rng.integers(300, 640))
        f = rng.standard_normal((n_obj, feat_dim)).astype(np.float32)
        cls = int(rng.integers(0, n_classes))
        img_class[iid] = cls
        if class_encoding == "binary":
            bits = (cls >> np.arange(n_bits)) & 1
            f[:, :n_bits] = (2.0 * bits - 1.0) * 2.0
        else:
            f[:, 0] = cls
        xy1 = rng.uniform(0, 0.5, size=(n_obj, 2))
        wh = rng.uniform(0.05, 0.45, size=(n_obj, 2))
        b = np.concatenate([xy1, xy1 + wh], axis=-1).astype(np.float32)
        b[:, [0, 2]] *= w           # pixel boxes, as written to disk
        b[:, [1, 3]] *= h
        size = np.array([w, h], dtype=np.float32)
        b[:, [0, 2]] /= size[0]     # normalized, as the loader reads them
        b[:, [1, 3]] /= size[1]
        feats[iid], boxes[iid] = f, b
    ids = list(feats)
    order = sorted(ids)             # the loader's row order
    store = FeatureStore(np.stack([feats[i] for i in order]),
                         np.stack([boxes[i] for i in order]),
                         {iid: row for row, iid in enumerate(order)})

    q_words = [f"word{i}" for i in range(q_vocab)]
    q_itow = {i + 1: w for i, w in enumerate(q_words)}
    q_wtoi = {w: i + 1 for i, w in enumerate(q_words)}
    a_words = [f"answer{i}" for i in range(n_answers)]
    a_itow = {i: w for i, w in enumerate(a_words)}
    a_wtoi = {w: i for i, w in enumerate(a_words)}

    def make_rows(count, qid0):
        rows = []
        for j in range(count):
            iid = ids[int(rng.integers(0, n_images))]
            qlen = int(rng.integers(3, 9))
            toks = [q_words[int(rng.integers(0, q_vocab))]
                    for _ in range(qlen)]
            qtype = int(rng.integers(0, 2))
            toks[0] = q_words[qtype]  # question type token
            ans = a_words[img_class[iid] * 2 + qtype]
            rows.append({
                "question": " ".join(toks) + "?",
                "question_id": qid0 + j,
                "image_id": iid,
                "question_toked": toks,
                "answer": ans,
                "answers": [[ans, 10]],
                "answers_w_scores": [[ans, 1.0]],
            })
        return rows

    n_train = int(n_questions * 0.75)
    splits = {"train": make_rows(n_train, 0),
              "val": make_rows(n_questions - n_train, 10_000)}
    splits["trainval"] = splits["train"] + splits["val"]
    stores = dict.fromkeys(splits, store)
    if with_test:
        tids = ids[:max(2, n_images // 4)]
        rows = make_rows(n_questions // 4, 20_000)
        for r in rows:
            r["image_id"] = tids[int(rng.integers(0, len(tids)))]
            del r["answers"], r["answers_w_scores"], r["answer"]
        splits["test"] = rows
        test_order = sorted(tids)
        stores["test"] = FeatureStore(
            np.stack([feats[i] for i in test_order]),
            np.stack([boxes[i] for i in test_order]),
            {iid: row for row, iid in enumerate(test_order)})
    return {name: GraphVQADataset.from_rows(
        stores[name], rows, q_itow, q_wtoi, a_itow, a_wtoi,
        emb_dim=emb_dim, max_qlen=max_qlen)
        for name, rows in splits.items()}
