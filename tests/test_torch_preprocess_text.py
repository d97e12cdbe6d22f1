"""The port's VQA v2 preprocessors against the JAX package's, on small
raw files the test writes under the published names: every output of
``run_phase`` / ``main`` (train, val, test) equal byte for byte, the
tokenizer's rule, and ``features_to_zarr`` on a base64 TSV: the same
arrays and size CSV, each package reading the other's stores."""

import base64
import json
import os

import numpy as np
import pytest

from vqa_project_tpu.data import open_group as j_open_group
from vqa_project_tpu.data.preprocess import image_features as j_image
from vqa_project_tpu.data.preprocess import text as j_text
from vqa_project_tpu_torch.data.preprocess import image_features, text
from vqa_project_tpu_torch.data.store import _read_sizes_csv
from vqa_project_tpu_torch.data.zarr_store import open_group

PHASES = ("train", "val", "test")
WORDS = ["what", "color", "is", "the", "dog", "How", "many", "cats?", "?",
         "wh?at", "Is", "there", "a", "red", "car", "on", "left"]
ANSWERS = ["blue", "2", "yes", "no", "red", "gray", "3", "many"]


def _raw_vqa(raw_dir, seed=0, n=40):
    """VQA v2 raw jsons for train, val and test under the names
    run_phase reads, with '?' in odd places, repeated answers and
    answers outside the top-n vocabulary."""
    rng = np.random.default_rng(seed)
    os.makedirs(raw_dir, exist_ok=True)
    for phase, year, qid0 in (("train", 2014, 0), ("val", 2014, 1000),
                              ("test", 2015, 5000)):
        questions, annotations = [], []
        for i in range(n):
            toks = rng.choice(WORDS, size=int(rng.integers(2, 8)))
            questions.append({"question": " ".join(toks) + "?",
                              "question_id": qid0 + i,
                              "image_id": int(rng.integers(100, 110))})
            votes = [{"answer": str(rng.choice(ANSWERS))}
                     for _ in range(10)]
            annotations.append({
                "question_id": qid0 + i, "answers": votes,
                "multiple_choice_answer": str(rng.choice(ANSWERS[:6]))})
        with open(os.path.join(raw_dir, f"v2_OpenEnded_mscoco_{phase}{year}"
                               "_questions.json"), "w") as f:
            json.dump({"questions": questions}, f)
        if phase != "test":
            with open(os.path.join(
                    raw_dir, f"v2_mscoco_{phase}{year}_annotations.json"),
                    "w") as f:
                json.dump({"annotations": annotations}, f)


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("text_in", [
    "What color is the dog?", "Is it red? yes", "Is it red ?", "wh?at",
    "  MANY   spaces\there ", "??", "", "ends with?? two"])
def test_tokenize_matches_jax(text_in):
    assert text.tokenize(text_in) == j_text.tokenize(text_in)


@pytest.mark.parametrize("n_answers", [3, 3000])
@pytest.mark.parametrize("phase", PHASES)
def test_run_phase_matches_jax(tmp_path, phase, n_answers):
    raw = str(tmp_path / "raw")
    _raw_vqa(raw)
    os.makedirs(tmp_path / "p")
    os.makedirs(tmp_path / "j")
    text.run_phase(phase, raw, str(tmp_path / "p"), n_answers=n_answers)
    j_text.run_phase(phase, raw, str(tmp_path / "j"), n_answers=n_answers)
    got, want = _files(tmp_path / "p"), _files(tmp_path / "j")
    assert sorted(got) == sorted(want) and got
    for name in want:
        assert got[name] == want[name], name
    if phase == "train":
        assert "train_q_dict.p" in got and "train_a_dict.p" in got


def test_main_matches_jax(tmp_path, capsys):
    raw = str(tmp_path / "raw")
    _raw_vqa(raw, seed=4)
    os.makedirs(tmp_path / "p")
    os.makedirs(tmp_path / "j")
    argv = ["--data", *PHASES, "--nanswers", "5", "--raw_dir", raw]
    text.main([*argv, "--out_dir", str(tmp_path / "p")])
    mine = capsys.readouterr().out
    j_text.main([*argv, "--out_dir", str(tmp_path / "j")])
    assert mine == capsys.readouterr().out
    assert _files(tmp_path / "p") == _files(tmp_path / "j")
    with pytest.raises(SystemExit):
        text.main(["--bogus"])


def test_misaligned_annotations_raise(tmp_path):
    questions = {"questions": [{"question": "a?", "question_id": 1,
                                "image_id": 1}]}
    annotations = [{"question_id": 2, "answers": [],
                    "multiple_choice_answer": "x"}]
    with pytest.raises(ValueError, match="annotation id 2"):
        text.combine_qa(questions, annotations, "train", str(tmp_path))


def _write_tsv(path, seed, n_images=5, n_boxes=(36, 36, 10, 36, 1),
               feat=12):
    rng = np.random.default_rng(seed)
    want = {}
    with open(path, "w") as f:
        for i in range(n_images):
            n = n_boxes[i]
            boxes = rng.uniform(0, 500, (n, 4)).astype(np.float32)
            feats = rng.standard_normal((n, feat)).astype(np.float32)
            w, h = int(rng.integers(200, 640)), int(rng.integers(200, 640))
            iid = str(1000 + 7 * i + seed)
            enc = [base64.encodebytes(a.tobytes()).decode("utf-8").replace(
                "\n", "") for a in (boxes, feats)]
            f.write("\t".join([iid, str(w), str(h), str(n), *enc]) + "\n")
            want[iid] = (boxes, feats, (w, h))
    return want


def _store(d, phase):
    return (open_group(os.path.join(d, f"{phase}.zarr")),
            open_group(os.path.join(d, f"{phase}_boxes.zarr")))


@pytest.mark.parametrize("n_files", [1, 2])
def test_features_to_zarr_matches_jax(tmp_path, n_files):
    tsvs = [str(tmp_path / f"part{i}.tsv") for i in range(n_files)]
    want = {}
    for i, path in enumerate(tsvs):
        want.update(_write_tsv(path, seed=i))
    for d in ("p", "j"):
        os.makedirs(tmp_path / d)
    image_features.features_to_zarr("trainval", tsvs, str(tmp_path / "p"))
    j_image.features_to_zarr("trainval", tsvs, str(tmp_path / "j"))
    csv = "trainval_image_size.csv"
    with open(tmp_path / "p" / csv, "rb") as a, \
            open(tmp_path / "j" / csv, "rb") as b:
        assert a.read() == b.read()
    sizes = _read_sizes_csv(str(tmp_path / "p" / csv))
    for d in ("p", "j"):
        # the port reads both packages' stores, and JAX reads both too
        for feats, boxes in (_store(str(tmp_path / d), "trainval"),
                             (j_open_group(str(tmp_path / d /
                                               "trainval.zarr")),
                              j_open_group(str(tmp_path / d /
                                               "trainval_boxes.zarr")))):
            assert sorted(feats.keys()) == sorted(want)
            for iid, (b, f, wh) in want.items():
                np.testing.assert_array_equal(np.asarray(feats[iid]), f)
                np.testing.assert_array_equal(np.asarray(boxes[iid]), b)
                assert tuple(sizes[iid]) == wh


def test_features_to_zarr_default_layout(tmp_path, capsys):
    """infiles=None reads DEFAULT_TSVS under raw_dir, as JAX does; main
    converts every phase; an unknown phase exits."""
    assert image_features.DEFAULT_TSVS == j_image.DEFAULT_TSVS
    assert image_features.FIELDNAMES == j_image.FIELDNAMES
    raw = tmp_path / "raw"
    want = {}
    for phase, names in image_features.DEFAULT_TSVS.items():
        for name in names:
            os.makedirs(raw / os.path.dirname(name), exist_ok=True)
            want[phase] = _write_tsv(str(raw / name), seed=len(want) + 3)
    out = tmp_path / "out"
    os.makedirs(out)
    image_features.main(["--data", "trainval", "test", "--raw_dir",
                         str(raw), "--out_dir", str(out)])
    assert capsys.readouterr().out.strip().endswith("Done")
    for phase, images in want.items():
        feats, boxes = _store(str(out), phase)
        assert sorted(feats.keys()) == sorted(images)
        for iid, (b, f, _) in images.items():
            np.testing.assert_array_equal(np.asarray(feats[iid]), f)
            np.testing.assert_array_equal(np.asarray(boxes[iid]), b)
    with pytest.raises(SystemExit):
        image_features.features_to_zarr("val2014", raw_dir=str(raw),
                                        out_dir=str(out))
