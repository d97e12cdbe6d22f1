"""Per-question tables and the dataset adapters.

Copy of ``vqa_project_tpu/data/datasets.py``: ``QuestionTable`` (token
ids, lengths and sparse answer/vote entries per question, densified per
batch) and ``GraphVQADataset`` (a FeatureStore, a QuestionTable and the
vocabularies, with the reference dataset's attribute surface), built in
memory (``from_rows``) or from the reference's on-disk artifacts:
``vqa2`` (VQA v2 train / val / trainval / test), ``imageclef`` and
``mimic``, each reading zarr feature and box groups, ``*_image_size.csv``,
vocabulary pickles, the QA json and, when present, GloVe vectors.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from vqa_project_tpu_torch.data.glove import (load_glove_embeddings,
                                              random_embeddings)
from vqa_project_tpu_torch.data.store import FeatureStore
# the sizes writer, where the JAX package keeps it (data/datasets.py)
from vqa_project_tpu_torch.data.store import write_sizes_csv  # noqa: F401
from vqa_project_tpu_torch.data.vocab import load_vocab

# capacity for per-question sparse answer entries (VQA has <= 10 raters)
MAX_ANS = 16


class QuestionTable:
    """Dense per-question arrays built once from QA rows.

    Each row carries ``question_toked`` (tokens), ``question_id``,
    ``image_id`` and, when annotated, ``answers_w_scores`` ([word, soft
    score] pairs, the training target) and ``answers`` ([word, votes]
    pairs or a dict, the metric's votes). Sparse entries point at the
    pad column ``n_answers - 1`` when unused: the reference's dense
    vector has one more slot than the answer vocabulary, never a label.
    ``image_id_suffix`` is appended to each row's image id before the
    store lookup (ImageCLEF keys its images "<id>.jpg").
    """

    def __init__(self, vqa: List[dict], q_wtoi: Dict[str, int],
                 a_wtoi: Dict[str, int], n_answers: int,
                 id_to_row: Dict[str, int], max_qlen: int,
                 image_id_suffix: str = ""):
        n = len(vqa)
        self.n_questions = n
        self.n_answers = n_answers
        self.max_qlen = max_qlen
        self.tokens = np.zeros((n, max_qlen), dtype=np.int32)
        self.qlen = np.zeros((n,), dtype=np.int32)
        self.qid = np.zeros((n,), dtype=np.int64)
        self.image_row = np.zeros((n,), dtype=np.int32)
        pad = n_answers - 1
        self.ans_idx = np.full((n, MAX_ANS), pad, dtype=np.int32)
        self.ans_score = np.zeros((n, MAX_ANS), dtype=np.float32)
        self.vote_idx = np.full((n, MAX_ANS), pad, dtype=np.int32)
        self.vote_val = np.zeros((n, MAX_ANS), dtype=np.float32)

        for r, row in enumerate(vqa):
            toks = row["question_toked"]
            self.qlen[r] = max(1, min(len(toks), max_qlen))
            for i, w in enumerate(toks[:max_qlen]):
                self.tokens[r, i] = q_wtoi.get(w, 0)
            self.qid[r] = int(row["question_id"])
            self.image_row[r] = id_to_row[str(row["image_id"])
                                          + image_id_suffix]
            self._fill(r, row.get("answers_w_scores", []), a_wtoi,
                       self.ans_idx, self.ans_score)
            answers = row.get("answers", [])
            if isinstance(answers, dict):  # ImageCLEF stores a dict
                answers = list(answers.items())
            self._fill(r, answers, a_wtoi, self.vote_idx, self.vote_val)

    @staticmethod
    def _fill(r, pairs, a_wtoi, idx, val):
        for s, (w, c) in enumerate(pairs):
            if s >= MAX_ANS:
                break
            j = a_wtoi.get(w)
            if j is not None:
                idx[r, s] = j
                val[r, s] = c

    def dense_answers(self, rows: np.ndarray):
        """Densify (answers, votes) for a batch: (B, C) float32 each, the
        pad column cleared."""
        b = len(rows)
        a = np.zeros((b, self.n_answers), dtype=np.float32)
        v = np.zeros((b, self.n_answers), dtype=np.float32)
        ar = np.arange(b)[:, None]
        a[ar, self.ans_idx[rows]] = self.ans_score[rows]
        v[ar, self.vote_idx[rows]] = self.vote_val[rows]
        a[:, self.n_answers - 1] = 0.0
        v[:, self.n_answers - 1] = 0.0
        return a, v


class GraphVQADataset:
    """A (FeatureStore, QuestionTable, vocabularies) bundle with the
    reference dataset's attribute surface (q_words, n_answers, a_itow,
    feat_dim, pretrained_wemb, n_questions)."""

    def __init__(self, store: FeatureStore, table: QuestionTable,
                 q_itow, q_wtoi, a_itow, a_wtoi,
                 pretrained_wemb: np.ndarray, vqa: List[dict]):
        self.store = store
        self.table = table
        self.q_itow, self.q_wtoi = q_itow, q_wtoi
        self.a_itow, self.a_wtoi = a_itow, a_wtoi
        self.pretrained_wemb = pretrained_wemb
        self.vqa = vqa
        self.q_words = len(q_itow) + 1
        self.n_answers = len(a_itow) + 1
        self.feat_dim = store.feat_dim
        self.n_obj = store.n_obj
        self.n_questions = table.n_questions
        self.max_qlen = table.max_qlen

    def __len__(self) -> int:
        return self.n_questions

    @classmethod
    def from_rows(cls, store: FeatureStore, vqa: List[dict], q_itow,
                  q_wtoi, a_itow, a_wtoi, *, emb_dim: int = 300,
                  max_qlen: int = 16, pretrained_wemb=None,
                  image_id_suffix: str = "") -> "GraphVQADataset":
        """Build the table from QA rows; without ``pretrained_wemb`` the
        embeddings are ``random_embeddings`` (q_words, emb_dim)."""
        n_answers = len(a_itow) + 1
        table = QuestionTable(vqa, q_wtoi, a_wtoi, n_answers,
                              store.id_to_row, max_qlen,
                              image_id_suffix=image_id_suffix)
        if pretrained_wemb is None:
            pretrained_wemb = random_embeddings(len(q_itow) + 1, emb_dim)
        return cls(store, table, q_itow, q_wtoi, a_itow, a_wtoi,
                   pretrained_wemb, vqa)

    # ---------------- from the reference's artifacts ----------------

    @classmethod
    def vqa2(cls, data_dir: str, split: str = "train", emb_dim: int = 300,
             n_obj: int = 36, max_qlen: int = 16) -> "GraphVQADataset":
        """VQA v2. split: 'train' or 'val' (their final_3000 jsons over
        the trainval store), 'trainval' (both jsons), 'test' (the
        test2015 store and its tokenized json, unannotated)."""
        q_itow, q_wtoi = load_vocab(os.path.join(data_dir, "train_q_dict.p"))
        a_itow, a_wtoi = load_vocab(os.path.join(data_dir, "train_a_dict.p"))
        jsons = {"train": ["vqa_train_final_3000.json"],
                 "val": ["vqa_val_final_3000.json"],
                 "trainval": ["vqa_train_final_3000.json",
                              "vqa_val_final_3000.json"],
                 "test": ["vqa_test_toked.json"]}
        if split not in jsons:
            raise ValueError(f"unknown split {split!r}")
        vqa = [row for name in jsons[split]
               for row in _load_json(os.path.join(data_dir, name))]
        prefix = "test" if split == "test" else "trainval"
        store = FeatureStore.from_zarr(
            os.path.join(data_dir, f"{prefix}.zarr"),
            os.path.join(data_dir, f"{prefix}_boxes.zarr"),
            os.path.join(data_dir, f"{prefix}_image_size.csv"), n_obj)
        return cls._assemble(data_dir, store, vqa, q_itow, q_wtoi,
                             a_itow, a_wtoi, emb_dim, max_qlen)

    @classmethod
    def imageclef(cls, data_dir: str, split: str = "train",
                  emb_dim: int = 300, n_obj: int = 51,
                  max_qlen: int = 16) -> "GraphVQADataset":
        """ImageCLEF-VQA-Med: train and val read the same json (as the
        reference does), image ids are keyed '<id>.jpg'."""
        del split
        q_itow, q_wtoi = load_vocab(
            os.path.join(data_dir, "imageclef_q_dict.p"))
        a_itow, a_wtoi = load_vocab(
            os.path.join(data_dir, "imageclef_a_dict.p"))
        vqa = _load_json(os.path.join(data_dir, "vqa_imageclef_final.json"))
        store = FeatureStore.from_zarr(
            os.path.join(data_dir, "imageclef_features.zarr"),
            os.path.join(data_dir, "imageclef_boxes.zarr"),
            os.path.join(data_dir, "imageclef_image_size.csv"), n_obj)
        return cls._assemble(data_dir, store, vqa, q_itow, q_wtoi,
                             a_itow, a_wtoi, emb_dim, max_qlen,
                             image_id_suffix=".jpg")

    @classmethod
    def mimic(cls, data_dir: str, split: str = "train", emb_dim: int = 300,
              n_obj: int = 51, max_qlen: int = 16) -> "GraphVQADataset":
        """MIMIC-CXR: vocabulary, features and QA json per split ('train',
        anything else reads 'val')."""
        s = "train" if split == "train" else "val"
        q_itow, q_wtoi = load_vocab(
            os.path.join(data_dir, f"mimic_q_{s}_dict.p"))
        a_itow, a_wtoi = load_vocab(
            os.path.join(data_dir, f"mimic_a_{s}_dict.p"))
        vqa = _load_json(os.path.join(data_dir, f"vqa_mimic_{s}_final.json"))
        store = FeatureStore.from_zarr(
            os.path.join(data_dir, f"mimic_{s}_features.zarr"),
            os.path.join(data_dir, f"mimic_{s}_boxes.zarr"),
            os.path.join(data_dir, f"mimic_{s}_image_size.csv"), n_obj)
        return cls._assemble(data_dir, store, vqa, q_itow, q_wtoi,
                             a_itow, a_wtoi, emb_dim, max_qlen)

    @classmethod
    def _assemble(cls, data_dir, store, vqa, q_itow, q_wtoi, a_itow,
                  a_wtoi, emb_dim, max_qlen, image_id_suffix=""):
        wemb = load_glove_embeddings(data_dir, q_wtoi, emb_dim,
                                     len(q_itow) + 1)
        return cls.from_rows(store, vqa, q_itow, q_wtoi, a_itow, a_wtoi,
                             emb_dim=emb_dim, max_qlen=max_qlen,
                             pretrained_wemb=wemb,
                             image_id_suffix=image_id_suffix)


def _load_json(path: str):
    with open(path) as f:
        return json.load(f)
