"""The port's file-backed data layer against the JAX package's, on the
CPU: the VQA v2 / ImageCLEF / MIMIC adapters over the JAX generators'
files and over the real-format fixture after the JAX preprocessors, bit
for bit; GloVe vectors and their cache; the port's synthetic writer
against the JAX one and against the port's in-memory generator; packs
reused across the packages, and repacked when the store changes."""

import filecmp
import json
import os
import pickle
import shutil

import numpy as np
import pytest

from vqa_project_tpu.data import datasets as j_ds
from vqa_project_tpu.data import glove as j_glove
from vqa_project_tpu.data import zarr_store as j_zarr
from vqa_project_tpu.data.synthetic import generate_synthetic_vqa as j_gen
from vqa_project_tpu.data.synthetic_medical import (
    generate_synthetic_imageclef, generate_synthetic_mimic)
from vqa_project_tpu_torch.data import (GraphVQADataset, FeatureStore,
                                        generate_synthetic_vqa,
                                        load_glove_embeddings,
                                        random_embeddings,
                                        write_synthetic_vqa, zarr_store)

TABLE_FIELDS = ("tokens", "qlen", "qid", "image_row", "ans_idx",
                "ans_score", "vote_idx", "vote_val")
GEN = dict(n_images=10, n_questions=40, n_obj=6, feat_dim=12, q_vocab=18,
           n_answers=8, seed=5)
REAL = os.path.join(os.path.dirname(__file__), "fixtures",
                    "vqa2_real_format")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def assert_same_dataset(got, want):
    """Every array and count the model and the loader read."""
    _same(got.store.features, want.store.features)
    _same(got.store.boxes, want.store.boxes)
    assert got.store.id_to_row == want.store.id_to_row
    for f in TABLE_FIELDS:
        _same(getattr(got.table, f), getattr(want.table, f))
    _same(got.pretrained_wemb, want.pretrained_wemb)
    for attr in ("q_words", "n_answers", "feat_dim", "n_obj",
                 "n_questions", "max_qlen"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.a_itow == want.a_itow and got.q_wtoi == want.q_wtoi


def _twin(path, tmp_path):
    """A copy of ``path``: each package packs its own."""
    other = str(tmp_path / (os.path.basename(path) + "_twin"))
    shutil.copytree(path, other)
    return other


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_synth"))
    j_gen(d, with_test=True, **GEN)
    return d


@pytest.mark.parametrize("split", ["train", "val", "trainval", "test"])
def test_vqa2_matches_jax(jax_dir, tmp_path, split):
    mine = _twin(jax_dir, tmp_path)
    want = j_ds.GraphVQADataset.vqa2(jax_dir, split, n_obj=6, max_qlen=7)
    got = GraphVQADataset.vqa2(mine, split, n_obj=6, max_qlen=7)
    assert_same_dataset(got, want)
    assert os.path.dirname(got.store.features.filename) == os.path.join(
        mine, "_tpu_cache")


def test_vqa2_fewer_boxes_and_unknown_split(jax_dir, tmp_path):
    mine = _twin(jax_dir, tmp_path)
    assert_same_dataset(GraphVQADataset.vqa2(mine, "val", n_obj=4),
                        j_ds.GraphVQADataset.vqa2(jax_dir, "val", n_obj=4))
    with pytest.raises(ValueError, match="split"):
        GraphVQADataset.vqa2(mine, "dev")


@pytest.mark.parametrize("split", ["train", "val"])
def test_medical_adapters_match_jax(tmp_path, split):
    clef = str(tmp_path / "clef")
    generate_synthetic_imageclef(clef, n_images=6, n_questions=20, n_obj=9,
                                 feat_dim=8, seed=3)
    mimic = str(tmp_path / "mimic")
    generate_synthetic_mimic(mimic, n_images=6, n_questions=20, n_obj=9,
                             feat_dim=8, seed=4)
    for path, j_fn, fn in (
            (clef, j_ds.GraphVQADataset.imageclef,
             GraphVQADataset.imageclef),
            (mimic, j_ds.GraphVQADataset.mimic, GraphVQADataset.mimic)):
        mine = _twin(path, tmp_path)
        assert_same_dataset(fn(mine, split, n_obj=9),
                            j_fn(path, split, n_obj=9))


def test_real_format_fixture_matches_jax(tmp_path):
    """The official file formats through the JAX preprocessors, then both
    packages' loaders (GloVe absent: the no-GloVe rows)."""
    from vqa_project_tpu.data.preprocess.image_features import \
        features_to_zarr
    from vqa_project_tpu.data.preprocess.text import run_phase

    out = str(tmp_path / "artifacts")
    os.makedirs(out)
    run_phase("train", raw_dir=REAL, out_dir=out)
    features_to_zarr("trainval", infiles=[os.path.join(
        REAL, "trainval_resnet101_faster_rcnn_genome_36.tsv")], out_dir=out)
    mine = _twin(out, tmp_path)
    got = GraphVQADataset.vqa2(mine, "train")
    assert_same_dataset(got, j_ds.GraphVQADataset.vqa2(out, "train"))
    _same(got.store.features[got.store.id_to_row["262148"]],
          np.load(os.path.join(REAL, "expected_features.npy")))


def _write_glove(data_dir, words, dim=8):
    rng = np.random.default_rng(11)
    with open(os.path.join(data_dir, f"glove.6B.{dim}d.txt"), "w") as f:
        for w in words:
            vec = rng.normal(size=dim).astype(np.float32)
            f.write(w + " " + " ".join(f"{x:.6f}" for x in vec) + "\n")


def test_glove_vectors_and_cache(tmp_path):
    d = str(tmp_path)
    wtoi = {"word1": 1, "word3": 2, "absent": 3, "word0": 4}
    _write_glove(d, ["word0", "the", "word1", "word3", "zebra"])
    want = j_glove.load_glove_embeddings(d, wtoi, emb_dim=8)
    cache = [f for f in os.listdir(os.path.join(d, "_tpu_cache"))
             if f.startswith("glove_")]
    assert len(cache) == 1
    got = load_glove_embeddings(d, wtoi, emb_dim=8)
    _same(got, want)
    assert got.shape == (5, 8) and not got[0].any() and not got[3].any()
    # the port reads the JAX package's cache file: mark it and read again
    marked = np.full_like(want, 7.0)
    np.save(os.path.join(d, "_tpu_cache", cache[0]), marked)
    _same(load_glove_embeddings(d, wtoi, emb_dim=8), marked)
    # no GloVe file: the rows both packages draw without one
    _same(load_glove_embeddings(str(tmp_path / "none"), wtoi, emb_dim=8,
                                vocab_size=6),
          j_glove.load_glove_embeddings(str(tmp_path / "none"), wtoi,
                                        emb_dim=8, vocab_size=6))
    _same(random_embeddings(6, 8), load_glove_embeddings(
        str(tmp_path / "none"), wtoi, emb_dim=8, vocab_size=6))


def test_vqa2_reads_glove(jax_dir, tmp_path):
    mine = _twin(jax_dir, tmp_path)
    theirs = _twin(jax_dir, tmp_path / "j")
    for d in (mine, theirs):
        _write_glove(d, [f"word{i}" for i in range(0, 18, 2)], dim=8)
    got = GraphVQADataset.vqa2(mine, "train", emb_dim=8, n_obj=6)
    assert_same_dataset(got, j_ds.GraphVQADataset.vqa2(
        theirs, "train", emb_dim=8, n_obj=6))
    assert not got.pretrained_wemb[2].any()      # word1: not in the file


def _read_tree(root):
    """{relative path: parsed content} of a synthetic artifact set."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for fname in files:
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, root)
            if fname.endswith(".json"):
                with open(path) as f:
                    out[rel] = json.load(f)
            elif fname.endswith(".p"):
                with open(path, "rb") as f:
                    out[rel] = pickle.load(f)
            elif fname.endswith(".csv"):
                with open(path) as f:
                    out[rel] = f.read()
    for group in ("trainval.zarr", "trainval_boxes.zarr", "test.zarr",
                  "test_boxes.zarr"):
        g = zarr_store.open_group(os.path.join(root, group))
        out[group] = {k: np.asarray(g[k]) for k in g.keys()}
    return out


@pytest.mark.parametrize("kw", [
    dict(GEN, with_test=True),
    dict(n_images=9, n_questions=33, n_obj=5, feat_dim=10, q_vocab=12,
         n_answers=40, n_classes=20, class_encoding="binary", seed=9,
         with_test=True)], ids=["scalar", "binary"])
def test_synthetic_writer_matches_jax(tmp_path, kw):
    j_gen(str(tmp_path / "j"), **kw)
    write_synthetic_vqa(str(tmp_path / "p"), **kw)
    want, got = _read_tree(str(tmp_path / "j")), _read_tree(
        str(tmp_path / "p"))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, dict) and key.endswith(".zarr"):
            assert sorted(got[key]) == sorted(value)
            for k in value:
                _same(got[key][k], value[k])
        else:
            assert got[key] == value, key
    # and the files themselves, byte for byte
    cmp = filecmp.dircmp(str(tmp_path / "j"), str(tmp_path / "p"))
    assert not (cmp.left_only or cmp.right_only or cmp.diff_files)


def test_files_equal_the_in_memory_generator(tmp_path):
    d = write_synthetic_vqa(str(tmp_path / "s"), with_test=True, **GEN)
    mem = generate_synthetic_vqa(**GEN, emb_dim=300, max_qlen=9,
                                 with_test=True)
    for split in ("train", "val", "trainval", "test"):
        assert_same_dataset(
            GraphVQADataset.vqa2(d, split, n_obj=GEN["n_obj"], max_qlen=9),
            mem[split])


def _pack_state(data_dir):
    cache = os.path.join(data_dir, "_tpu_cache")
    return {f: os.stat(os.path.join(cache, f)).st_mtime_ns
            for f in sorted(os.listdir(cache)) if f.startswith("packed_")}


@pytest.mark.parametrize("first", ["jax", "port"])
def test_a_pack_is_reused_by_the_other_package(tmp_path, first):
    d = str(tmp_path / "s")
    write_synthetic_vqa(d, with_test=True, **GEN)
    loaders = {"jax": j_ds.GraphVQADataset.vqa2,
               "port": GraphVQADataset.vqa2}
    ds_first = loaders[first](d, "train", n_obj=6)
    packed = _pack_state(d)
    assert len(packed) == 3
    second = loaders["port" if first == "jax" else "jax"](d, "val", n_obj=6)
    assert _pack_state(d) == packed          # no repack, mtimes unchanged
    assert second.store.features.filename == ds_first.store.features.filename
    _same(second.store.features, ds_first.store.features)


def test_a_store_regenerated_in_place_repacks(tmp_path):
    d = str(tmp_path / "s")
    write_synthetic_vqa(d, **GEN)
    before = GraphVQADataset.vqa2(d, "train", n_obj=6)
    old = _pack_state(d)
    old_feats = np.array(before.store.features)
    j_gen(d, **dict(GEN, seed=GEN["seed"] + 1))
    after = GraphVQADataset.vqa2(d, "train", n_obj=6)
    new = _pack_state(d)
    assert len(new) == 3 and not set(new) & set(old)   # old packs removed
    assert not np.array_equal(np.asarray(after.store.features), old_feats)
    twin = _twin(d, tmp_path)
    assert_same_dataset(after, j_ds.GraphVQADataset.vqa2(twin, "train",
                                                         n_obj=6))


def test_non_finite_features_raise(tmp_path):
    d = str(tmp_path)
    f = j_zarr.ZarrWriter(os.path.join(d, "f.zarr"))
    b = j_zarr.ZarrWriter(os.path.join(d, "b.zarr"))
    feat = np.ones((3, 4), np.float32)
    feat[1, 2] = np.inf
    f.create_dataset("1", feat)
    b.create_dataset("1", np.ones((3, 4), np.float32))
    j_ds.write_sizes_csv(os.path.join(d, "s.csv"), {"1": (10, 20)})
    with pytest.raises(ValueError, match="non-finite"):
        FeatureStore.from_zarr(os.path.join(d, "f.zarr"),
                               os.path.join(d, "b.zarr"),
                               os.path.join(d, "s.csv"), 3)
