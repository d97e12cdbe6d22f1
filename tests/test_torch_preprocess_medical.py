"""The port's synthetic medical sets and medical preprocessors against
the JAX package's, on the CPU.

Both generators with one seed, and both preprocessors on the same
region-feature ``.pt`` dumps (the reference's {'feat', 'image_id',
'img_sizes'} schema, as tests/test_preprocess.py builds them, with an
image missing from one dump and one with too few boxes), write the same
files byte for byte; the zarr arrays read back equal through either
package's reader, and so do the json rows and the vocabulary pickles.
"""

import csv
import json
import os
import pickle

import numpy as np
import pytest
import torch

from vqa_project_tpu.data import open_group as j_open_group
from vqa_project_tpu.data.preprocess import medical as j_medical
from vqa_project_tpu.data.synthetic_medical import (
    generate_synthetic_imageclef as j_clef, generate_synthetic_mimic as j_mimic)
from vqa_project_tpu.data.vocab import (build_answer_vocab as j_answers,
                                        build_question_vocab as j_questions)
from vqa_project_tpu_torch.data import (GraphVQADataset,
                                        build_answer_vocab,
                                        build_question_vocab)
from vqa_project_tpu_torch.data.preprocess import medical
from vqa_project_tpu_torch.data.synthetic_medical import (
    generate_synthetic_imageclef, generate_synthetic_mimic)
from vqa_project_tpu_torch.data.zarr_store import open_group

SIZES = dict(n_images=5, n_questions=24, n_obj=9, feat_dim=12, q_vocab=10,
             n_answers=6, seed=7)


def _files(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for folder, _, names in os.walk(root):
        for name in names:
            path = os.path.join(folder, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _same_tree(mine, theirs):
    a, b = _files(mine), _files(theirs)
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name] == b[name], name
    for name in a:
        if name.endswith(".zarr/.zgroup"):
            group = os.path.dirname(name)
            g1 = open_group(os.path.join(mine, group))
            g2 = j_open_group(os.path.join(theirs, group))
            assert sorted(g1.keys()) == sorted(g2.keys())
            for k in g1.keys():
                x, y = np.asarray(g1[k]), np.asarray(g2[k])
                assert x.dtype == y.dtype and np.array_equal(x, y), k
        elif name.endswith(".json"):
            with open(os.path.join(mine, name)) as f1, \
                    open(os.path.join(theirs, name)) as f2:
                assert json.load(f1) == json.load(f2)
        elif name.endswith(".p"):
            with open(os.path.join(mine, name), "rb") as f1, \
                    open(os.path.join(theirs, name), "rb") as f2:
                assert pickle.load(f1) == pickle.load(f2)
    return a


@pytest.mark.parametrize("kind", ["imageclef", "mimic"])
def test_synthetic_sets_equal_jax(tmp_path, kind):
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    gen = {"imageclef": (generate_synthetic_imageclef, j_clef),
           "mimic": (generate_synthetic_mimic, j_mimic)}[kind]
    assert gen[0](mine, **SIZES) == mine
    gen[1](theirs, **SIZES)
    files = _same_tree(mine, theirs)
    assert any(f.endswith(".zarr/.zgroup") for f in files)
    splits = ["train"] if kind == "imageclef" else ["train", "val"]
    for split in splits:
        ds = getattr(GraphVQADataset, kind)(mine, split, emb_dim=8,
                                            n_obj=SIZES["n_obj"])
        assert ds.n_questions == SIZES["n_questions"]
        assert ds.feat_dim == SIZES["feat_dim"] + 4


def _dumps(folder, rng, n_images=5, per=17, fd=10):
    """Three dumps: img4 only in detect's, img3 with 16 gaze boxes."""
    def dump(name, extras, images, short=None):
        feats, ids, sizes = [], [], []
        for i in images:
            rows = rng.normal(size=(per + 2 - (i == short) * 3,
                                    fd + extras)).astype(np.float32)
            hi = -extras + 4 if extras > 4 else None
            rows[:, -extras:hi] = rng.uniform(0, 200, size=(len(rows), 4))
            feats.append(torch.from_numpy(rows))
            ids.append(f"img{i}.jpg")
            sizes.append((240 + i, 320 - i))
        path = os.path.join(folder, name)
        torch.save({"feat": feats, "image_id": ids, "img_sizes": sizes},
                   path)
        return path

    os.makedirs(folder, exist_ok=True)
    return (dump("detect.pt", 6, range(n_images)),
            dump("gaze.pt", 6, range(n_images - 1), short=3),
            dump("gaze_on_detect.pt", 4, range(n_images - 1)))


@pytest.fixture
def dumps(tmp_path):
    return _dumps(str(tmp_path / "dumps"), np.random.default_rng(11))


def test_merge_box_feat_equals_jax(dumps):
    loaded = [torch.load(p, weights_only=False) for p in dumps]
    mine = medical.merge_box_feat(*loaded)
    theirs = j_medical.merge_box_feat(*loaded)
    assert sorted(mine) == sorted(theirs) == ["img0.jpg", "img1.jpg",
                                              "img2.jpg"]
    for k in mine:
        assert mine[k]["size"] == theirs[k]["size"] == (320 - int(k[3]),
                                                        240 + int(k[3]))
        for part in ("feat", "boxes"):
            assert np.array_equal(mine[k][part], theirs[k][part])
        assert mine[k]["feat"].shape == (51, 10)


def test_preprocess_imageclef_equals_jax(tmp_path, dumps):
    qa = str(tmp_path / "qa.txt")
    with open(qa, "w") as f:
        f.write("img0|What organ is shown?|lung\n")
        f.write("img1|is there a fracture ?|no\n")
        f.write("img2|what organ is shown?|Liver\n")
        f.write("img3|bogus?|x\n")          # img3 was dropped by the merge
        f.write("img0|is there a mass?|no\n")
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    rows = medical.preprocess_imageclef(*dumps, [qa], mine)
    j_rows = j_medical.preprocess_imageclef(*dumps, [qa], theirs)
    assert rows == j_rows and len(rows) == 4
    _same_tree(mine, theirs)
    ds = GraphVQADataset.imageclef(mine, emb_dim=8, n_obj=51)
    assert ds.n_questions == 4 and ds.feat_dim == 14


def test_preprocess_mimic_equals_jax(tmp_path, dumps):
    qa = str(tmp_path / "mimic_all_qa_pairs.csv")
    with open(qa, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["dicom_id", "question", "answer"])
        w.writeheader()
        for i in range(9):
            w.writerow({"dicom_id": f"img{i % 5}",
                        "question": f"is finding {i} present?",
                        "answer": ["yes;no;yes", "no", "left;right"][i % 3]})
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    for split in ("train", "val"):
        rows = medical.preprocess_mimic(*dumps, qa, split, mine,
                                        train_rows=6, test_rows=3)
        j_rows = j_medical.preprocess_mimic(*dumps, qa, split, theirs,
                                            train_rows=6, test_rows=3)
        assert rows == j_rows
    _same_tree(mine, theirs)
    tr = GraphVQADataset.mimic(mine, "train", emb_dim=8, n_obj=51)
    va = GraphVQADataset.mimic(mine, "val", emb_dim=8, n_obj=51)
    # rows 0-5 and 6-8, less img3's (dropped by the merge)
    assert tr.n_questions == 4 and va.n_questions == 2


def test_nih_and_the_cli_equal_jax(tmp_path, dumps):
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    merged = medical.preprocess_nih(*dumps, mine)
    j_medical.preprocess_nih(*dumps, theirs)
    assert sorted(merged) == ["img0.jpg", "img1.jpg", "img2.jpg"]
    _same_tree(mine, theirs)
    qa = str(tmp_path / "qa.txt")
    with open(qa, "w") as f:
        f.write("img1|where is it?|chest\n")
    flags = ["--detect_pt", dumps[0], "--gaze_pt", dumps[1],
             "--gaze_on_detect_pt", dumps[2], "--qa", qa]
    medical.main(["imageclef", *flags, "--out_dir", mine + "2"])
    j_medical.main(["imageclef", *flags, "--out_dir", theirs + "2"])
    _same_tree(mine + "2", theirs + "2")
    with pytest.raises(SystemExit, match="Unknown argument"):
        medical.main(["nih", *flags, "--bogus"])
    with pytest.raises(SystemExit, match="exactly one --qa"):
        medical.main(["mimic", *flags[:-2], "--out_dir", mine])


def test_vocab_builders_equal_jax():
    rng = np.random.default_rng(4)
    words = [f"w{i}" for i in range(30)]
    toks = [[words[j] for j in rng.integers(0, 30, rng.integers(1, 8))]
            for _ in range(50)]
    assert build_question_vocab(toks) == j_questions(toks)
    answers = [words[j] for j in rng.integers(0, 12, 200)]
    for n in (3, 10, 10**9):
        assert build_answer_vocab(answers, n) == j_answers(answers, n)
