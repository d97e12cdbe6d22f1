"""The port's plot CLI on the CPU (``--device cpu``): ``--synthetic``
writes the JAX generator's files byte for byte (the JPEGs too) or
backfills them; the sweep from each checkpoint kind (a JAX msgpack, the
reference ``.pt`` exported from it, the port's ``.ckpt``) writes the same
files, their CSV equal to JAX's ``visualize_checkpoint`` on the same
weights; ``--question``; JAX's flags (less ``--num_devices``, plus
``--device``) with unknown ones refused; the card is the default."""

import os

import numpy as np
import pytest
import torch

from vqa_project_tpu.cli import plot as j_plot
from vqa_project_tpu.config import ModelConfig as JModelConfig
from vqa_project_tpu.config import TrainConfig as JTrainConfig
from vqa_project_tpu.data import GraphVQADataset as JDataset
from vqa_project_tpu.data.synthetic import ensure_synthetic_images as j_ensure
from vqa_project_tpu.data.synthetic import generate_synthetic_vqa as j_gen
from vqa_project_tpu.train.loop import build_model as j_build_model
from vqa_project_tpu.train.state import create_train_state
from vqa_project_tpu.train.state import make_optimizer as j_make_optimizer
from vqa_project_tpu.train.state import save_checkpoint as j_save
from vqa_project_tpu.viz import visualize_checkpoint as j_visualize
from vqa_project_tpu_torch.cli import export_torch, plot
from vqa_project_tpu_torch.config import ModelConfig
from vqa_project_tpu_torch.data import GraphVQADataset
from vqa_project_tpu_torch.data.synthetic import (ensure_synthetic_images,
                                                  write_synthetic_vqa)
from vqa_project_tpu_torch.train import build_model
from vqa_project_tpu_torch.train.state import (load_checkpoint,
                                               save_checkpoint)
from vqa_project_tpu_torch.viz import read_adj

N_OBJ, EMB, BS, N_BATCHES = 8, 16, 8, 2
MODEL_FLAGS = ["--emb", str(EMB), "--hid", "24", "--n_kernels", "3",
               "--neighbourhood_size", "4", "--n_obj", str(N_OBJ),
               "--compute_dtype", "float32"]
MODEL = dict(emb_dim=EMB, hid_dim=24, n_kernels=3, neighbourhood_size=4,
             n_obj=N_OBJ, compute_dtype="float32")
KINDS = ["msgpack", "pt", "ckpt"]


@pytest.fixture(autouse=True)
def flush_denormals():
    """XLA:CPU flushes denormals; run torch's CPU kernels the same way
    (see tests/test_torch_model.py)."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _tree(root):
    """{relative path: bytes} of every file under root but the packed
    stores (``_tpu_cache/``: a cache that the loader writes)."""
    out = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "_tpu_cache"]
        for fname in files:
            path = os.path.join(dirpath, fname)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _assert_same_tree(got_root, want_root):
    got, want = _tree(got_root), _tree(want_root)
    assert sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """``<root>/synthetic`` written by the port's CLI (--synthetic), the
    same set written by the JAX generator as the JAX CLI calls it, and a
    checkpoint of random f32 weights in each kind."""
    root = tmp_path_factory.mktemp("plot_cli")
    jdir = str(root / "jax_synthetic")
    j_gen(jdir, with_test=True, n_obj=N_OBJ, with_images=True)
    jds = JDataset.vqa2(jdir, "val", EMB, N_OBJ)
    mcfg = JModelConfig(**MODEL, use_pallas=False)
    jmodel = j_build_model(mcfg, jds)
    sample = {"question": np.zeros((2, jds.max_qlen), np.int32),
              "image": np.zeros((2, jds.n_obj, jds.feat_dim), np.float32),
              "qlen": np.ones((2,), np.int32)}
    state = create_train_state(jmodel, mcfg, j_make_optimizer(
        JTrainConfig(), 4), sample, seed=11)
    paths = {k: str(root / f"model.{k}") for k in KINDS}
    paths["msgpack"] = str(root / "jax.ckpt")
    j_save(paths["msgpack"], state, epoch=1)
    export_torch.main([paths["msgpack"], paths["pt"]])
    pds = GraphVQADataset.vqa2(jdir, "val", EMB, N_OBJ)
    model = build_model(ModelConfig(**MODEL), pds, device="cpu")
    load_checkpoint(paths["msgpack"], model)
    save_checkpoint(paths["ckpt"], model, step=0, epoch=1)
    return str(root), jdir, paths, (jmodel, state.params, jds)


def _main(root, path, out, *extra):
    plot.main(["--synthetic", "--data_dir", root, *MODEL_FLAGS,
               "--device", "cpu", "--model_path", path, "--plot_dir", out,
               "--bsize", str(BS), "--n_batches", str(N_BATCHES), *extra])


@pytest.fixture(scope="module")
def sweeps(data, tmp_path_factory):
    """The CLI's sweep from each checkpoint kind; the first call writes
    ``<root>/synthetic``."""
    root, _, paths, _ = data
    outs = {}
    for kind in KINDS:
        outs[kind] = str(tmp_path_factory.mktemp(f"figs_{kind}"))
        _main(root, paths[kind], outs[kind])
    return outs


def test_synthetic_files_equal_the_jax_generator(data, sweeps):
    root, jdir, _, _ = data
    _assert_same_tree(os.path.join(root, "synthetic"), jdir)
    assert len(os.listdir(os.path.join(jdir, "images"))) == 24


@pytest.mark.parametrize("kind", KINDS)
def test_sweep_from_each_checkpoint_kind(data, sweeps, kind):
    root, jdir, _, (jmodel, params, jds) = data
    out = sweeps[kind]
    names = os.listdir(out)
    assert sum(n.endswith(".jpg") for n in names) == BS * N_BATCHES
    assert {"infer_predictions.csv", "adjacencies.npz",
            "summary.json"} <= set(names)
    # every kind holds the same f32 weights: the same files, bit for bit
    # (the JPEGs included)
    if kind != KINDS[0]:
        _assert_same_tree(out, sweeps[KINDS[0]])
    npz = read_adj(os.path.join(out, "adjacencies.npz"))
    assert npz["adjacency"].shape == (BS * N_BATCHES, N_OBJ, N_OBJ)
    np.testing.assert_array_equal(npz["index"], np.arange(BS * N_BATCHES))


def test_sweep_csv_equals_jax(data, sweeps, tmp_path):
    _, jdir, _, (jmodel, params, jds) = data
    out = j_visualize(jmodel, params, jds, str(tmp_path / "j"),
                      batch_size=BS, n_batches=N_BATCHES, num_devices=1,
                      image_dir=os.path.join(jdir, "images"))
    csv = "infer_predictions.csv"
    with open(os.path.join(out, csv), "rb") as a, \
            open(os.path.join(sweeps["msgpack"], csv), "rb") as b:
        assert a.read() == b.read()
    want = read_adj(os.path.join(out, "adjacencies.npz"))["adjacency"]
    got = read_adj(os.path.join(sweeps["msgpack"], "adjacencies.npz"))
    np.testing.assert_allclose(got["adjacency"], want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("kind", ["pt", "ckpt"])
def test_question_figure(data, sweeps, tmp_path, capsys, kind):
    root, jdir, paths, (_, _, jds) = data
    row = jds.vqa[2]
    out = str(tmp_path / "q")
    _main(root, paths[kind], out, "--question", row["question"],
          "--image_id", str(row["image_id"]))
    path = os.path.join(out, "given_question.jpg")
    assert os.path.getsize(path) > 5_000
    assert f"figure written to {path}" in capsys.readouterr().out
    with pytest.raises(KeyError):
        _main(root, paths[kind], out, "--question", "no such question?")


def test_synthetic_backfills_the_images_as_jax(data, tmp_path):
    """A set written without JPEGs: --synthetic backfills them, equal to
    the JAX backfill byte for byte; ensure_synthetic_images keeps files
    that exist."""
    _, _, paths, _ = data
    kw = dict(n_images=6, n_questions=24, n_obj=N_OBJ)
    sdir = str(tmp_path / "p" / "synthetic")
    write_synthetic_vqa(sdir, with_test=True, **kw)
    jdir = str(tmp_path / "j")
    j_gen(jdir, with_test=True, **kw)
    j_ensure(jdir)
    _main(str(tmp_path / "p"), paths["pt"], str(tmp_path / "figs"))
    _assert_same_tree(sdir, jdir)
    first = os.path.join(sdir, "images", "100.jpg")
    os.remove(first)
    with open(os.path.join(sdir, "images", "101.jpg"), "wb") as f:
        f.write(b"kept")
    assert ensure_synthetic_images(sdir) == os.path.join(sdir, "images")
    with open(os.path.join(sdir, "images", "101.jpg"), "rb") as f:
        assert f.read() == b"kept"
    with open(first, "rb") as a, \
            open(os.path.join(jdir, "images", "100.jpg"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("kw", [dict(with_test=False), dict(with_test=True),
                                dict(with_test=True, n_obj=5, seed=3)])
def test_with_images_changes_later_draws_as_jax(tmp_path, kw):
    """The rasters come from the generator inside the image loop, so
    with_images changes the next images' features and the questions,
    in both packages alike."""
    kw = dict(n_images=5, n_questions=16, **kw)
    j_gen(str(tmp_path / "j"), with_images=True, **kw)
    write_synthetic_vqa(str(tmp_path / "p"), with_images=True, **kw)
    _assert_same_tree(str(tmp_path / "p"), str(tmp_path / "j"))
    write_synthetic_vqa(str(tmp_path / "plain"), **kw)
    with open(tmp_path / "p" / "vqa_train_final_3000.json") as a, \
            open(tmp_path / "plain" / "vqa_train_final_3000.json") as b:
        assert a.read() != b.read()


def test_flags_and_defaults_are_the_jax_cli():
    mine = vars(plot.input_args(["--model_path", "m"]))
    theirs = vars(j_plot.input_args(["--model_path", "m"]))
    assert mine.pop("device") == "cuda"
    assert theirs.pop("num_devices") is None
    assert mine == theirs


@pytest.mark.parametrize("argv", [["--num_devices", "2"], ["--bogus"],
                                  ["--pallas"], ["--tp", "2"]])
def test_unknown_flags_raise(argv):
    with pytest.raises(SystemExit):
        plot.input_args(["--model_path", "m", *argv])


def test_model_path_is_required():
    with pytest.raises(SystemExit):
        plot.input_args([])


def test_the_card_is_the_default(data, tmp_path, monkeypatch):
    """Without --device the CLI asks for the card and, with none, raises
    before it writes or reads anything."""
    _, _, paths, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = tmp_path / "d"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        plot.main(["--synthetic", "--data_dir", str(root), *MODEL_FLAGS,
                   "--model_path", paths["pt"], "--plot_dir",
                   str(tmp_path / "f")])
    assert not root.exists() and not (tmp_path / "f").exists()
