"""The port's data layer against the JAX package's: QuestionTable, the
host-mode Batcher's order and batches, and the synthetic generator with
its test split (whose JAX counterpart writes files that its loader reads
back)."""

import numpy as np
import pytest

from vqa_project_tpu.data import datasets as j_ds
from vqa_project_tpu.data.loader import Batcher as JBatcher
from vqa_project_tpu.data.synthetic import generate_synthetic_vqa as j_gen
from vqa_project_tpu_torch.data import (Batcher, FeatureStore,
                                        GraphVQADataset, QuestionTable,
                                        generate_synthetic_vqa)

TABLE_FIELDS = ("tokens", "qlen", "qid", "image_row", "ans_idx",
                "ans_score", "vote_idx", "vote_val")


def _rows(rng, n=23, n_images=5):
    words = [f"w{i}" for i in range(12)] + ["unknown"]
    answers = [f"a{i}" for i in range(6)] + ["not_in_vocab"]
    rows = []
    for j in range(n):
        toks = list(rng.choice(words, size=int(rng.integers(0, 20))))
        scored = [[str(rng.choice(answers)), float(rng.uniform())]
                  for _ in range(int(rng.integers(0, 19)))]
        votes = [[a, int(rng.integers(1, 10))] for a, _ in scored[:4]]
        row = {"question_toked": toks, "question_id": 1000 + j,
               "image_id": str(100 + j % n_images),
               "answers_w_scores": scored}
        row["answers"] = dict(votes) if j % 3 == 0 else votes
        rows.append(row)
    q_wtoi = {f"w{i}": i + 1 for i in range(12)}
    a_wtoi = {f"a{i}": i for i in range(6)}
    return rows, q_wtoi, a_wtoi


def _datasets(rng, n_images=5, n=23):
    rows, q_wtoi, a_wtoi = _rows(rng, n, n_images)
    feats = rng.normal(size=(n_images, 4, 6)).astype(np.float32)
    boxes = rng.uniform(size=(n_images, 4, 4)).astype(np.float32)
    ids = {str(100 + i): i for i in range(n_images)}
    q_itow = {v: k for k, v in q_wtoi.items()}
    a_itow = {v: k for k, v in a_wtoi.items()}
    wemb = rng.normal(size=(13, 5)).astype(np.float32)
    j_store = j_ds.FeatureStore(feats, boxes, ids)
    jds = j_ds.GraphVQADataset(
        j_store, j_ds.QuestionTable(rows, q_wtoi, a_wtoi, 7, ids, 8),
        q_itow, q_wtoi, a_itow, a_wtoi, wemb, rows)
    pds = GraphVQADataset.from_rows(
        FeatureStore(feats, boxes, ids), rows, q_itow, q_wtoi, a_itow,
        a_wtoi, max_qlen=8, pretrained_wemb=wemb)
    return jds, pds


def test_question_table_matches_jax(rng):
    jds, pds = _datasets(rng)
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(pds.table, f),
                                      getattr(jds.table, f), err_msg=f)
    rows = np.array([3, 0, 22, 3])
    for got, want in zip(pds.table.dense_answers(rows),
                         jds.table.dense_answers(rows)):
        np.testing.assert_array_equal(got, want)
    for attr in ("q_words", "n_answers", "feat_dim", "n_obj", "n_questions",
                 "max_qlen"):
        assert getattr(pds, attr) == getattr(jds, attr), attr
    with pytest.raises(KeyError):      # a question whose image is unknown
        QuestionTable([{"question_toked": [], "question_id": 1,
                        "image_id": "999"}], {}, {}, 3, {}, 4)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False),
                                               (False, False)])
def test_batcher_matches_jax_host_mode(rng, shuffle, drop_last):
    jds, pds = _datasets(rng)
    jb = JBatcher(jds, 5, shuffle=shuffle, seed=7, drop_last=drop_last,
                  materialize=True)
    pb = Batcher(pds, 5, shuffle=shuffle, seed=7, drop_last=drop_last)
    assert len(pb) == len(jb)
    for _ in range(2):                      # two epochs: the order moves
        got, want = list(pb), list(jb)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # resume: epoch 4, skipping its first two batches
    jb.set_epoch(3, skip=2)
    pb.set_epoch(3, skip=2)
    for g, w in zip(pb, jb):
        np.testing.assert_array_equal(g["index"], w["index"])


def test_synthetic_matches_jax_files(tmp_path):
    kw = dict(n_images=24, n_questions=96, n_obj=36, feat_dim=64,
              q_vocab=40, n_answers=12, seed=1000, n_classes=5,
              class_encoding="binary", with_test=True)
    j_gen(str(tmp_path), **kw)
    port = generate_synthetic_vqa(**kw, emb_dim=300, max_qlen=16)
    assert set(port) == {"train", "val", "trainval", "test"}
    # the test split: its own store over the first n_images // 4 images,
    # unannotated questions
    assert port["test"].store.features.shape[0] == 6
    assert not any("answers" in row for row in port["test"].vqa)
    for split in ("train", "val", "trainval", "test"):
        jds = j_ds.GraphVQADataset.vqa2(str(tmp_path), split)
        pds = port[split]
        assert pds.store.id_to_row == jds.store.id_to_row
        np.testing.assert_array_equal(pds.store.features,
                                      np.asarray(jds.store.features))
        np.testing.assert_array_equal(pds.store.boxes,
                                      np.asarray(jds.store.boxes))
        for f in TABLE_FIELDS:
            np.testing.assert_array_equal(getattr(pds.table, f),
                                          getattr(jds.table, f), err_msg=f)
        np.testing.assert_array_equal(pds.pretrained_wemb,
                                      jds.pretrained_wemb)
        assert pds.vqa == jds.vqa
        assert pds.a_itow == jds.a_itow and pds.q_wtoi == jds.q_wtoi
