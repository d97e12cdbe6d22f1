"""The port's medical grid search (``cli/medical.py``, ``run_imageclef``,
``run_mimic``) on the CPU, at small widths (hid 24, emb 16, 9 objects,
f32): the flags and defaults of the JAX harness; one- and two-cell grids
on ImageCLEF and MIMIC writing the grid line, the named checkpoint (a
port checkpoint under a ``.pt`` name) and a CSV row per validation
question; one feature cache per store for the whole grid; --fast_math's
bfloat16 Adam moments; and, on the same carried-over JAX weights (fit
replaced in both packages), the grid line and the CSV equal to the JAX
harness's, byte for byte.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqa_project_tpu.cli import medical as j_medical
from vqa_project_tpu.config import TrainConfig as JTrainConfig
from vqa_project_tpu.data import Batcher as JBatcher
from vqa_project_tpu.train import loop as j_loop
from vqa_project_tpu.train.state import create_train_state
from vqa_project_tpu.train.state import make_optimizer as j_make_optimizer
from vqa_project_tpu_torch.cli import medical, run_imageclef, run_mimic
from vqa_project_tpu_torch.data.synthetic_medical import (
    generate_synthetic_imageclef, generate_synthetic_mimic)
from vqa_project_tpu_torch.models import state_dict_from_jax_params
from vqa_project_tpu_torch.train import loop
from vqa_project_tpu_torch.train.state import (is_port_checkpoint,
                                               load_checkpoint,
                                               make_optimizer)

N_OBJ = 9
GEN = dict(n_images=6, n_questions=32, n_obj=N_OBJ, feat_dim=16,
           q_vocab=12, n_answers=6)
SMALL = ["--ep", "2", "--bsize", "8", "--hid", "24", "--emb", "16",
         "--n_obj", str(N_OBJ), "--compute_dtype", "float32", "--device",
         "cpu"]
MAINS = {"imageclef": (run_imageclef.main, "clef"),
         "mimic": (run_mimic.main, "mimic")}


@pytest.fixture(autouse=True)
def flush_denormals():
    """XLA:CPU flushes denormals; run torch's CPU kernels the same way
    (see tests/test_torch_model.py)."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("medical")
    dirs = {"imageclef": str(root / "clef"), "mimic": str(root / "mimic")}
    generate_synthetic_imageclef(dirs["imageclef"], **GEN)
    generate_synthetic_mimic(dirs["mimic"], **GEN)
    return dirs


def _shared_defaults(argv):
    mine = vars(medical.medical_input_args(argv)[0])
    theirs = vars(j_medical.medical_input_args(argv)[0])
    return mine, theirs


def test_flags_and_defaults_are_the_jax_harness():
    mine, theirs = _shared_defaults([])
    added = {"device", "adam_mu_dtype", "adam_nu_dtype", "fast_math",
             "synthetic_images", "synthetic_questions", "synthetic_feat_dim",
             "synthetic_vocab", "synthetic_answers"}
    assert set(mine) == (set(theirs) - {"num_devices"}) | added
    assert {k: mine[k] for k in theirs if k in mine} == \
        {k: v for k, v in theirs.items() if k != "num_devices"}
    assert mine["device"] == "cuda"
    assert medical.make_configs(medical.medical_input_args([])[0])[0] \
        .n_obj == 51
    _, _, unparsed = medical.medical_input_args(["--num_devices", "2"])
    assert unparsed == ["--num_devices", "2"]
    with pytest.raises(SystemExit, match="Unknown argument"):
        run_imageclef.main(["--num_devices", "2"])


@pytest.mark.parametrize("value,want", [
    (None, True), ("False", False), ("false", False), ("0", False),
    ("no", False), ("True", True), ("true", True), ("1", True),
    ("yes", True)])
def test_train_flag_str2bool(value, want):
    argv = ["--train"] + ([value] if value else [])
    mine, theirs = _shared_defaults(argv)
    assert mine["train"] is theirs["train"] is want


def test_train_false_prints_help(capsys):
    assert run_mimic.main(["--train", "false"]) is None
    assert "usage" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        medical.medical_input_args(["--train", "maybe"])


@pytest.mark.parametrize("kind", ["imageclef", "mimic"])
def test_the_card_is_the_default(kind, data_dirs, tmp_path, monkeypatch):
    """Without --device the grid asks for the card and, with none, raises
    before anything runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MAINS[kind][0](["--data_dir", data_dirs[kind], *SMALL[:-2],
                        "--neighbors_list", "4", "--kernels_list", "3"])
    assert not os.path.exists(tmp_path / "save")


def _grid(kind, data_dir, tmp_path, neighbors, kernels, *extra):
    """Run kind's main in tmp_path with the cache builds counted; returns
    (cells, builds)."""
    main, _ = MAINS[kind]
    builds = []
    real = loop.make_feature_cache

    def counting(ds, *a, **k):
        builds.append(ds)
        return real(ds, *a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(loop, "make_feature_cache", counting)
    mp.chdir(tmp_path)
    try:
        cells = main(["--data_dir", data_dir, "--save_dir", "save",
                      "--plot_dir", "figures", *SMALL,
                      "--neighbors_list", *map(str, neighbors),
                      "--kernels_list", *map(str, kernels), *extra])
    finally:
        mp.undo()
    return cells, builds


def _check_artifacts(kind, tmp_path, cells, val_questions):
    prefix = MAINS[kind][1]
    lines = (tmp_path / f"grid_search_nodes_{N_OBJ}.txt").read_text() \
        .splitlines()
    assert len(lines) == len(cells)
    for line, cell in zip(lines, cells):
        assert line == (f"neighbors: {cell.neighbors}, kernels: "
                        f"{cell.kernels}, Validation acc: {cell.acc:.3f} %")
        name = os.path.basename(cell.path)
        assert name == (f"{prefix}_{N_OBJ}_{cell.kernels}_{cell.neighbors}_"
                        f"{cell.acc:.2f}.pt")
        assert os.path.isfile(tmp_path / "save" / name)
        assert len(cell.rows) == len(cell.result) == val_questions
        assert cell.step_times["steps"] > 0
        payload = torch.load(tmp_path / cell.path, weights_only=True)
        assert is_port_checkpoint(payload)
        assert payload["extra"] == {"accuracy": cell.acc}
    (csv,) = os.listdir(tmp_path / "figures")
    best = max(cells, key=lambda c: c.acc)
    assert csv == f"{prefix}_{N_OBJ}_{best.acc:.2f}.csv"
    body = (tmp_path / "figures" / csv).read_text().splitlines()
    assert body[0] == "image_id,question,prediction,answer"
    assert body[1:] == best.rows
    assert all(row.count(",") == 3 for row in body)


@pytest.mark.parametrize("kind", ["imageclef", "mimic"])
def test_one_cell_grid(kind, data_dirs, tmp_path):
    cells, builds = _grid(kind, data_dirs[kind], tmp_path, [4], [3])
    assert [(c.neighbors, c.kernels) for c in cells] == [(4, 3)]
    _check_artifacts(kind, tmp_path, cells, GEN["n_questions"])
    # one store (ImageCLEF: train = val) or two (MIMIC), each cached once
    assert len(builds) == (1 if kind == "imageclef" else 2)


@pytest.mark.parametrize("kind", ["imageclef", "mimic"])
def test_two_cell_grid_builds_each_cache_once(kind, data_dirs, tmp_path):
    cells, builds = _grid(kind, data_dirs[kind], tmp_path, [4, 3], [3],
                          "--ep", "1")
    assert [(c.neighbors, c.kernels) for c in cells] == [(4, 3), (3, 3)]
    _check_artifacts(kind, tmp_path, cells, GEN["n_questions"])
    assert len(builds) == (1 if kind == "imageclef" else 2)
    if kind == "mimic":
        assert builds[0].store is not builds[1].store


def test_cells_past_n_obj_are_skipped(data_dirs, tmp_path):
    cells, _ = _grid("imageclef", data_dirs["imageclef"], tmp_path,
                     [4, N_OBJ + 1], [3, N_OBJ + 1], "--ep", "1")
    assert [(c.neighbors, c.kernels) for c in cells] == [(4, 3)]


def test_fast_math_checkpoint_holds_bf16_moments(data_dirs, tmp_path):
    """The grid's .pt loads through load_checkpoint as a port checkpoint,
    its Adam moments in bfloat16, step and scheduler restored."""
    cells, _ = _grid("mimic", data_dirs["mimic"], tmp_path, [4], [3],
                     "--fast_math", "--ep", "1")
    (cell,) = cells
    path = str(tmp_path / cell.path)
    payload = torch.load(path, weights_only=True)
    moments = [s for st in payload["optimizer"]["state"].values()
               for k, s in st.items() if k.startswith("exp_avg")]
    assert moments and all(m.dtype == torch.bfloat16 for m in moments)
    args = medical.medical_input_args(
        ["--data_dir", data_dirs["mimic"], *SMALL, "--fast_math",
         "--neighbourhood_size", "4", "--n_kernels", "3"])[0]
    train_ds, _ = medical._load_datasets(args, "mimic")
    mcfg, tcfg = medical.make_configs(args)
    model = loop.build_model(mcfg, train_ds, device="cpu")
    optimizer, scheduler = make_optimizer(model, tcfg, 4)
    got = load_checkpoint(path, model, optimizer, scheduler)
    steps = GEN["n_questions"] // 8
    assert got["step"] == steps and scheduler.last_epoch == steps
    for p in model.parameters():
        assert optimizer.state[p]["exp_avg"].dtype == torch.bfloat16
        assert optimizer.state[p]["exp_avg_sq"].dtype == torch.bfloat16


def _jax_params(mcfg, train_ds):
    """The JAX model of the cell and its init parameters plus 0.5 N(0, 1)
    (numpy, seeded), so that the answers vary."""
    model = j_loop.build_model(mcfg, train_ds)
    tx = j_make_optimizer(JTrainConfig(), 4)
    state = create_train_state(model, model.cfg, tx,
                               next(iter(JBatcher(train_ds, 8))), seed=3)
    rng = np.random.default_rng(5)
    params = jax.tree.map(
        lambda p: p + jnp.asarray(0.5 * rng.standard_normal(p.shape),
                                  p.dtype), state.params)
    return model, state.replace(params=params)


@pytest.mark.parametrize("kind", ["imageclef", "mimic"])
def test_csv_equals_the_jax_harness_on_its_weights(kind, data_dirs,
                                                   tmp_path, monkeypatch):
    """Both harnesses' fit replaced by the same JAX weights (no
    training): the grid line and the CSV are equal byte for byte."""
    held = {}

    def j_fit(tcfg, mcfg, train_ds, *a, **k):
        held["model"], held["state"] = _jax_params(mcfg, train_ds)
        return held["model"], held["state"], 0.0

    def p_fit(tcfg, mcfg, train_ds, *a, device="cpu", **k):
        model = loop.build_model(mcfg, train_ds, device=device)
        params = jax.tree.map(np.asarray, held["state"].params)
        model.load_state_dict(state_dict_from_jax_params(params))
        return model, make_optimizer(model, tcfg, 4)[0], 0.0

    monkeypatch.setattr(j_loop, "fit", j_fit)
    monkeypatch.setattr(loop, "fit", p_fit)
    out = {}
    for side in ("jax", "port"):
        folder = tmp_path / side
        folder.mkdir()
        monkeypatch.chdir(folder)
        argv = ["--data_dir", data_dirs[kind], "--save_dir", "save",
                "--plot_dir", "figures", *SMALL[:-2],
                "--neighbors_list", "4", "--kernels_list", "3",
                "--dropout", "0"]
        if side == "jax":
            args, parser, unparsed = j_medical.medical_input_args(argv)
            j_medical.grid_search_main(args, parser, unparsed,
                                       dataset_name=kind,
                                       ckpt_prefix=MAINS[kind][1])
        else:
            MAINS[kind][0](argv + ["--device", "cpu"])
        (csv,) = os.listdir(folder / "figures")
        out[side] = (csv, (folder / "figures" / csv).read_text(),
                     (folder / f"grid_search_nodes_{N_OBJ}.txt").read_text(),
                     sorted(os.listdir(folder / "save")))
    assert out["port"] == out["jax"]
    preds = {line.split(",")[2]
             for line in out["port"][1].splitlines()[1:]}
    assert len(preds) > 1, "the weights give one answer everywhere"
    assert re.fullmatch(rf"{MAINS[kind][1]}_{N_OBJ}_3_4_\d+\.\d\d\.pt",
                        out["port"][3][0])
