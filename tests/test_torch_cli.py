"""The port's CLI (``vqa_project_tpu_torch.cli.run``) on the CPU: every
mode with --synthetic at small widths writes its artifacts; left-out and
unknown flags, a missing --model_path and a cut msgpack checkpoint are
refused; the flags it keeps have the JAX CLI's names and defaults; both
CLIs share one synthetic directory; and one reference-format .pt
evaluated by the JAX CLI and by the port's gives the same accuracy and
answers (f32)."""

import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from vqa_project_tpu.cli import run as j_run
from vqa_project_tpu.data import Batcher as JBatcher
from vqa_project_tpu.train.loop import build_model as j_build_model
from vqa_project_tpu.train.state import load_checkpoint as j_load
from vqa_project_tpu_torch.cli import run
from vqa_project_tpu_torch.config import ModelConfig
from vqa_project_tpu_torch.data import GraphVQADataset
from vqa_project_tpu_torch.models import load_reference_checkpoint
from vqa_project_tpu_torch.train import build_model

SMALL = ["--synthetic", "--hid", "64", "--n_kernels", "4",
         "--neighbourhood_size", "5", "--bsize", "32", "--device", "cpu"]
# the JAX CLI's flags the port leaves out: tensor parallelism (not
# ported yet) and the TPU-only kernel switches
LEFT_OUT = {"tp", "pallas", "no_pallas", "pallas_gather"}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A data directory and the named .pt of a short --trainval run."""
    root = tmp_path_factory.mktemp("cli")
    data, save = str(root / "data"), str(root / "save")
    run.main(["--trainval", *SMALL, "--ep", "4", "--lr", "3e-3",
              "--data_dir", data, "--save_dir", save, "--log_interval", "3",
              "--eval_interval", "0", "--compute_dtype", "float32"])
    (name,) = [f for f in os.listdir(save) if f.endswith(".pt")]
    return data, os.path.join(save, name)


def test_trainval_saves_the_named_pt(trained):
    data, pt = trained
    assert re.fullmatch(r"vqa_36_4_5_\d+\.\d\d\.pt", os.path.basename(pt))
    payload = torch.load(pt, weights_only=True)
    assert payload["epoch"] == 4 and payload["step"] == 12
    assert payload["extra"]["config"]["hid"] == 64
    ds = GraphVQADataset.vqa2(os.path.join(data, "synthetic"), "val")
    model = build_model(ModelConfig(hid_dim=64, n_kernels=4,
                                    neighbourhood_size=5), ds, device="cpu")
    model.load_state_dict(load_reference_checkpoint(pt))
    for k, v in model.state_dict().items():
        assert torch.equal(v, payload["state_dict"][k]), k


def test_train_writes_checkpoints_and_metrics_and_resumes(trained,
                                                          tmp_path):
    data, _ = trained
    save = str(tmp_path / "save")
    common = [*SMALL, "--bsize", "24", "--data_dir", data,
              "--log_interval", "1", "--eval_interval", "2"]
    run.main(["--train", "--ep", "2", "--save_dir", save, *common])
    assert sorted(os.listdir(save)) == ["metrics.jsonl", "model_1.ckpt",
                                        "model_2.ckpt"]
    with open(os.path.join(save, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == list(range(1, 7))
    assert all(np.isfinite(r["loss"]) for r in recs)
    resumed = str(tmp_path / "resumed")
    run.main(["--train", "--ep", "1", "--save_dir", resumed, "--model_path",
              os.path.join(save, "model_1.ckpt"), *common])
    with open(os.path.join(resumed, "metrics.jsonl")) as f:
        again = [json.loads(line) for line in f]
    keys = ("epoch", "step", "loss", "vqa_acc", "lr")
    assert [[r[k] for k in keys] for r in again] == \
        [[r[k] for k in keys] for r in recs[3:]]
    assert sorted(os.listdir(resumed)) == ["metrics.jsonl", "model_2.ckpt"]


def _accuracy(out: str) -> float:
    (acc,) = re.findall(r"^accuracy: (\S+) %$", out, re.M)
    return float(acc)


def test_eval_and_test_write_result_json(trained, tmp_path, monkeypatch,
                                         capsys):
    data, pt = trained
    monkeypatch.chdir(tmp_path)
    run.main(["--eval", *SMALL, "--data_dir", data, "--model_path", pt])
    acc = _accuracy(capsys.readouterr().out)
    with open("result.json") as f:
        result = json.load(f)
    assert len(result) == 24 and 0.0 <= acc <= 100.0
    assert set(result[0]) == {"question_id", "answer"}
    run.main(["--test", *SMALL, "--data_dir", data, "--model_path", pt])
    out = capsys.readouterr().out
    assert "accuracy" not in out and "Testing done" in out
    with open("result.json") as f:
        assert len(json.load(f)) == 96 // 4


@pytest.mark.parametrize("extra", [
    ["--tp", "2"], ["--pallas"], ["--no_pallas"],
    ["--pallas_gather", "on"], ["--device_cache_bytes", "1"],
    ["--bogus"]], ids=lambda a: a[0])
def test_left_out_and_unknown_flags_exit(extra):
    with pytest.raises(SystemExit, match="Unknown argument"):
        run.main(["--train", *SMALL, *extra])


def test_refusals(trained, tmp_path):
    data, _ = trained
    with pytest.raises(SystemExit, match="Need to provide model path"):
        run.main(["--eval", *SMALL, "--data_dir", data])
    with pytest.raises(SystemExit, match="Need to provide model path"):
        run.main(["--test", *SMALL, "--data_dir", data, "--model_path",
                  str(tmp_path / "nothing.pt")])
    # the start of a msgpack map, as flax's, cut after its first key: JAX
    # checkpoints are read now, and a cut one is refused as such
    msgpack = str(tmp_path / "model.ckpt")
    with open(msgpack, "wb") as f:
        f.write(b"\x85\xa6params\x80")
    with pytest.raises(ValueError, match="not a complete flax msgpack"):
        run.main(["--eval", *SMALL, "--data_dir", data, "--model_path",
                  msgpack])
    with pytest.raises(ValueError, match="not a complete flax msgpack"):
        run.main(["--train", *SMALL, "--data_dir", data, "--model_path",
                  msgpack, "--save_dir", str(tmp_path / "s")])


def test_the_card_is_the_default(trained, tmp_path, monkeypatch):
    data, pt = trained
    args, _, _ = run.input_args([])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    cpu_free = [a for a in SMALL if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["--eval", *cpu_free, "--data_dir", data, "--model_path",
                  pt])


def test_cuda_resolves_to_the_current_card(monkeypatch):
    """A model on "cuda:0" and evaluate(device="cuda") name one device."""
    from vqa_project_tpu_torch.config import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device("cuda") == torch.device("cuda:0")
    assert resolve_device("cuda:1") == torch.device("cuda:1")
    assert resolve_device("cpu") == torch.device("cpu")


def _dests(parser):
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


def test_flags_keep_the_jax_names_and_defaults():
    _, parser, _ = run.input_args([])
    _, j_parser, _ = j_run.input_args([])
    mine, theirs = _dests(parser), _dests(j_parser)
    assert set(mine) == (set(theirs) - LEFT_OUT) | {"device"}
    for dest in set(mine) - {"device"}:
        assert mine[dest] == theirs[dest], dest
    flags = {s for a in parser._actions for s in a.option_strings}
    j_flags = {s for a in j_parser._actions for s in a.option_strings}
    assert flags == (j_flags - {f"--{d}" for d in LEFT_OUT}) | {"--device"}


def test_both_clis_share_one_synthetic_directory(trained, tmp_path):
    """The JAX CLI finds the port's set (same fingerprint) and regenerates
    nothing; a changed knob regenerates."""
    data = str(tmp_path / "data")
    shutil.copytree(trained[0], data)
    sdir = os.path.join(data, "synthetic")
    before = os.stat(os.path.join(sdir, "fingerprint.json")).st_mtime_ns
    j_args, _, _ = j_run.input_args(["--synthetic", "--data_dir", data])
    j_ds = j_run._dataset(j_args, "val")
    assert os.stat(os.path.join(sdir, "fingerprint.json")).st_mtime_ns \
        == before
    args, _, _ = run.input_args(["--synthetic", "--data_dir", data])
    assert j_ds.n_questions == run._dataset(args, "val").n_questions == 24
    args.synthetic_questions = 48
    ds = run._dataset(args, "val")
    assert ds.n_questions == 12
    with open(os.path.join(sdir, "fingerprint.json")) as f:
        assert json.load(f)["n_questions"] == 48


def test_eval_matches_the_jax_cli(trained, tmp_path, monkeypatch, capsys):
    """One reference-format .pt (a bare state_dict), --compute_dtype
    float32: the accuracies agree within 1e-4 and the answers are equal
    except where JAX's top two logits lie within 1e-5."""
    data, pt = trained
    ref = str(tmp_path / "reference.pt")
    torch.save(load_reference_checkpoint(pt), ref)
    argv = ["--eval", "--synthetic", "--hid", "64", "--n_kernels", "4",
            "--neighbourhood_size", "5", "--bsize", "32", "--data_dir",
            data, "--model_path", ref, "--compute_dtype", "float32"]
    monkeypatch.chdir(tmp_path)
    j_args, _, unparsed = j_run.input_args(argv)
    assert not unparsed
    j_run.eval_model(j_args)
    j_acc = _accuracy(capsys.readouterr().out)
    with open("result.json") as f:
        j_result = json.load(f)
    os.remove("result.json")
    run.main(argv + ["--device", "cpu"])
    acc = _accuracy(capsys.readouterr().out)
    with open("result.json") as f:
        result = json.load(f)
    assert abs(acc - j_acc) <= 1e-4
    assert [r["question_id"] for r in result] == \
        [r["question_id"] for r in j_result]
    # JAX's logits, for the near-tie rule
    j_ds = j_run._dataset(j_args, "val")
    mcfg, _ = j_run.make_configs(j_args)
    j_model = j_build_model(mcfg, j_ds)
    params = j_run.restore_params(j_model, j_ds, j_load(ref)[0])
    gaps = {}
    for b in JBatcher(j_ds, 32):
        logits = np.asarray(j_model.apply(params, b["question"], b["image"],
                                          b["qlen"])[0])
        top2 = np.sort(logits, axis=-1)[:, -2:]
        for qid, m, gap in zip(b["qid"], b["mask"], top2[:, 1] - top2[:, 0]):
            if m > 0:
                gaps[int(qid)] = float(gap)
    differ = [r["question_id"] for r, j in zip(result, j_result)
              if r["answer"] != j["answer"]]
    assert all(gaps[q] < 1e-5 for q in differ), differ
    assert len(differ) < len(result)
