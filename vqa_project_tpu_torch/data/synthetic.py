"""Synthetic VQA dataset, in memory or as the reference's files.

Counterpart of ``vqa_project_tpu/data/synthetic.py::
generate_synthetic_vqa``: the same numpy draws in the same order from
the same seed, so the same images, boxes, classes and questions.

- ``write_synthetic_vqa(data_dir, ...)`` writes the artifact set the
  VQA v2 adapter reads (zarr feature and box groups,
  ``*_image_size.csv``, ``train_q_dict.p`` / ``train_a_dict.p``,
  ``vqa_{train,val}_final_3000.json`` and, with ``with_test``, the test
  store and ``vqa_test_toked.json``), file for file what the JAX
  generator writes, with ``with_images`` its raw JPEGs too (one small
  random raster per image, drawn from the same generator after the
  image's boxes, so they change every later draw as in JAX);
- ``ensure_synthetic_images(data_dir)`` backfills those JPEGs for a set
  written without them, from a generator of its own;
- ``generate_synthetic_vqa(...)`` returns the splits as
  ``GraphVQADataset`` objects with no file written: image rows in the
  order the loader gives them (ids sorted as strings), boxes normalized
  by the image size in float32 as the loader does, and the no-GloVe
  ``random_embeddings``.

The task is learnable: the answer is a function of the question's first
token (its type) and of a class written into every region feature of
the image, so training accuracy above chance is a meaningful signal.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from vqa_project_tpu_torch.data.datasets import GraphVQADataset
from vqa_project_tpu_torch.data.store import (FeatureStore, _read_sizes_csv,
                                              write_sizes_csv)
from vqa_project_tpu_torch.data.vocab import save_vocab
from vqa_project_tpu_torch.data.zarr_store import ZarrWriter


def _draw(n_images, n_questions, n_obj, feat_dim, q_vocab, n_answers,
          seed, n_classes, class_encoding, with_test, with_images=False):
    """Every draw of the JAX generator, in its order: per image its size,
    features (the class written in), class, pixel boxes and, with_images,
    a (h // 8, w // 8, 3) uint8 raster (else None); then the QA
    rows of train, val and, with_test, test (unannotated, over the first
    max(2, n_images // 4) images)."""
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

    images, img_class = {}, {}
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
        raster = _raster(rng, w, h) if with_images else None
        images[iid] = (f, b, (w, h), raster)
    ids = list(images)

    q_words = [f"word{i}" for i in range(q_vocab)]
    a_words = [f"answer{i}" for i in range(n_answers)]

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
    test_ids = ids[:max(2, n_images // 4)]
    if with_test:
        rows = make_rows(n_questions // 4, 20_000)
        for r in rows:
            r["image_id"] = test_ids[int(rng.integers(0, len(test_ids)))]
            del r["answers"], r["answers_w_scores"], r["answer"]
        splits["test"] = rows
    return images, q_words, a_words, splits, test_ids


def _raster(rng: np.random.Generator, w: int, h: int) -> np.ndarray:
    """The raster JAX draws for a (w, h) image: (h // 8, w // 8, 3) uint8."""
    return rng.integers(0, 255, size=(h // 8, w // 8, 3), dtype=np.uint8)


def _imsave(path: str, raster: np.ndarray) -> None:
    """Write a JPEG as the JAX generator does (``plt.imsave`` is this
    function); matplotlib is imported only here."""
    from matplotlib.image import imsave

    imsave(path, raster)


def ensure_synthetic_images(data_dir: str, seed: int = 7) -> str:
    """Backfill raw JPEGs for an already-written synthetic set (one per
    id in the trainval size CSV, from ``default_rng(seed)``; existing
    files are kept), returning the images directory."""
    image_dir = os.path.join(data_dir, "images")
    os.makedirs(image_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    sizes = _read_sizes_csv(os.path.join(data_dir,
                                         "trainval_image_size.csv"))
    for iid, wh in sizes.items():
        path = os.path.join(image_dir, f"{iid}.jpg")
        if os.path.exists(path):
            continue
        _imsave(path, _raster(rng, int(wh[0]), int(wh[1])))
    return image_dir


def _vocabs(q_words, a_words):
    q_itow = {i + 1: w for i, w in enumerate(q_words)}
    q_wtoi = {w: i + 1 for i, w in enumerate(q_words)}
    a_itow = {i: w for i, w in enumerate(a_words)}
    a_wtoi = {w: i for i, w in enumerate(a_words)}
    return q_itow, q_wtoi, a_itow, a_wtoi


def write_synthetic_vqa(data_dir: str, n_images: int = 24,
                        n_questions: int = 96, n_obj: int = 36,
                        feat_dim: int = 64, q_vocab: int = 40,
                        n_answers: int = 12, seed: int = 1000,
                        with_test: bool = False, n_classes: int = 0,
                        class_encoding: str = "scalar",
                        with_images: bool = False) -> str:
    """Write the synthetic set as the reference's VQA v2 artifacts under
    ``data_dir`` (the arguments and files of the JAX generator); returns
    ``data_dir``. The questions split 75% train, 25% val; with_test adds
    n_questions // 4 unannotated test questions over a test store of the
    first max(2, n_images // 4) images; with_images writes
    ``images/{id}.jpg`` for the interpretability plots (needs
    matplotlib)."""
    images, q_words, a_words, splits, test_ids = _draw(
        n_images, n_questions, n_obj, feat_dim, q_vocab, n_answers, seed,
        n_classes, class_encoding, with_test, with_images)
    os.makedirs(data_dir, exist_ok=True)
    if with_images:
        image_dir = os.path.join(data_dir, "images")
        os.makedirs(image_dir, exist_ok=True)
        for iid, (_, _, _, raster) in images.items():
            _imsave(os.path.join(image_dir, f"{iid}.jpg"), raster)

    def write_store(prefix, ids):
        feats = ZarrWriter(os.path.join(data_dir, f"{prefix}.zarr"))
        boxes = ZarrWriter(os.path.join(data_dir, f"{prefix}_boxes.zarr"))
        for iid in ids:
            feats.create_dataset(iid, images[iid][0])
            boxes.create_dataset(iid, images[iid][1])
        write_sizes_csv(os.path.join(data_dir, f"{prefix}_image_size.csv"),
                        {iid: images[iid][2] for iid in ids})

    write_store("trainval", list(images))
    q_itow, q_wtoi, a_itow, a_wtoi = _vocabs(q_words, a_words)
    save_vocab(os.path.join(data_dir, "train_q_dict.p"), q_itow, q_wtoi)
    save_vocab(os.path.join(data_dir, "train_a_dict.p"), a_itow, a_wtoi)
    names = {"train": "vqa_train_final_3000.json",
             "val": "vqa_val_final_3000.json",
             "test": "vqa_test_toked.json"}
    for split, rows in splits.items():
        with open(os.path.join(data_dir, names[split]), "w") as f:
            json.dump(rows, f)
    if with_test:
        write_store("test", test_ids)
    return data_dir


def _store(images, ids) -> FeatureStore:
    """The store the loader packs from these images: rows in sorted-id
    order, boxes divided by the image size in float32."""
    order = sorted(ids)
    boxes = []
    for iid in order:
        b = images[iid][1].copy()
        size = np.array(images[iid][2], dtype=np.float32)
        b[:, [0, 2]] /= size[0]
        b[:, [1, 3]] /= size[1]
        boxes.append(b)
    return FeatureStore(np.stack([images[i][0] for i in order]),
                        np.stack(boxes),
                        {iid: row for row, iid in enumerate(order)})


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
    images, q_words, a_words, splits, test_ids = _draw(
        n_images, n_questions, n_obj, feat_dim, q_vocab, n_answers, seed,
        n_classes, class_encoding, with_test)
    vocabs = _vocabs(q_words, a_words)
    splits["trainval"] = splits["train"] + splits["val"]
    store = _store(images, list(images))
    stores = dict.fromkeys(splits, store)
    if with_test:
        stores["test"] = _store(images, test_ids)
    return {name: GraphVQADataset.from_rows(
        stores[name], rows, *vocabs, emb_dim=emb_dim, max_qlen=max_qlen)
        for name, rows in splits.items()}
