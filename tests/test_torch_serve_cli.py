"""The port's serving and parity CLIs on the CPU against the JAX
package's: ``cli.serve --synthetic`` (the smoke mode), ``build_server``
of both packages on one JAX checkpoint giving the same top-k answers (in
float32, and int8 with ``--quantize``), ``main`` serving HTTP in a
process of its own, ``--device cuda`` without a card, and
``cli.validate_parity`` printing JAX's numbers for one reference
``.pt``."""

import functools
import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from vqa_project_tpu import config as j_config
from vqa_project_tpu.cli import run as j_run
from vqa_project_tpu.cli import serve as j_serve
from vqa_project_tpu.cli import validate_parity as j_parity
from vqa_project_tpu.train.loop import build_model as j_build_model
from vqa_project_tpu.train.state import create_train_state
from vqa_project_tpu.train.state import make_optimizer as j_make_optimizer
from vqa_project_tpu.train.state import save_checkpoint as j_save
from vqa_project_tpu.config import TrainConfig as JTrainConfig
from vqa_project_tpu_torch import config as p_config
from vqa_project_tpu_torch.cli import export_torch, serve, validate_parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_FLAGS = ["--emb", "16", "--hid", "24", "--n_kernels", "3",
               "--neighbourhood_size", "4", "--n_obj", "8"]


@pytest.fixture(autouse=True)
def flush_denormals():
    """XLA:CPU flushes denormals; run torch's CPU kernels the same way
    (see tests/test_torch_model.py)."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A synthetic data directory and a JAX checkpoint of random weights
    at its widths (f32)."""
    data = str(tmp_path_factory.mktemp("serve_cli"))
    args = j_serve.input_args(["--synthetic", "--data_dir", data,
                               *MODEL_FLAGS, "--compute_dtype", "float32"])
    ds = j_run._dataset(args, "val")
    mcfg = j_config.ModelConfig(
        emb_dim=16, hid_dim=24, n_kernels=3, neighbourhood_size=4, n_obj=8,
        compute_dtype="float32", use_pallas=False)
    model = j_build_model(mcfg, ds)
    sample = {"question": np.zeros((2, ds.max_qlen), np.int32),
              "image": np.zeros((2, ds.n_obj, ds.feat_dim), np.float32),
              "qlen": np.ones((2,), np.int32)}
    state = create_train_state(model, mcfg, j_make_optimizer(
        JTrainConfig(), 4), sample, seed=9)
    path = os.path.join(data, "jax.ckpt")
    j_save(path, state, epoch=1)
    return data, path, list(ds.store.id_to_row)


def _flags(data, path, *extra):
    return ["--synthetic", "--data_dir", data, *MODEL_FLAGS,
            "--compute_dtype", "float32", "--bsize", "4", "--top_k", "3",
            "--model_path", path, *extra]


def _questions(image_ids, n=24):
    words = ["what", "color", "is", "the", "object", "thing", "left", "of"]
    rng = np.random.default_rng(3)
    return [(" ".join(rng.choice(words, size=int(rng.integers(2, 7)))),
             image_ids[i % len(image_ids)]) for i in range(n)]


def _answers(args_jax, args_port, image_ids, n=24):
    jsrv = j_serve.build_server(args_jax)
    tsrv = serve.build_server(args_port)
    try:
        return [(jsrv.predict(q, image_id=i), tsrv.predict(q, image_id=i))
                for q, i in _questions(image_ids, n)]
    finally:
        jsrv.close()
        tsrv.close()


def test_serve_cli_synthetic(tmp_path):
    """``cli.serve --synthetic`` without a checkpoint: random weights."""
    args = serve.input_args([
        "--synthetic", "--data_dir", str(tmp_path), *MODEL_FLAGS,
        "--compute_dtype", "float32", "--bsize", "4", "--device", "cpu"])
    srv = serve.build_server(args)
    try:
        out = srv.predict("is there a thing", image_id="100")
        assert isinstance(out["answer"], str) and len(out["top_k"]) == 5
    finally:
        srv.close()


def test_same_answers_as_jax_server(checkpoint):
    data, path, ids = checkpoint
    pairs = _answers(j_serve.input_args(_flags(data, path)),
                     serve.input_args(_flags(data, path, "--device", "cpu")),
                     ids)
    for want, got in pairs:
        assert [t["answer"] for t in got["top_k"]] == [
            t["answer"] for t in want["top_k"]]
        np.testing.assert_allclose(
            [t["prob"] for t in got["top_k"]],
            [t["prob"] for t in want["top_k"]], rtol=1e-4, atol=1e-5)


def test_quantized_answers_as_jax_server(checkpoint):
    """``--quantize`` on both sides: top-1 equal on at least 98% of the
    questions (an activation code may flip at a rounding tie, see
    tests/test_torch_quant.py)."""
    data, path, ids = checkpoint
    pairs = _answers(
        j_serve.input_args(_flags(data, path, "--quantize")),
        serve.input_args(_flags(data, path, "--quantize", "--device", "cpu")),
        ids, n=100)
    agree = np.mean([w["answer"] == g["answer"] for w, g in pairs])
    assert agree >= 0.98, agree


def test_main_serves_http(checkpoint, tmp_path):
    """``python -m vqa_project_tpu_torch.cli.serve`` in its own process,
    on port 0: it prints its address and answers /healthz and
    /predict."""
    data, path, ids = checkpoint
    proc = subprocess.Popen(
        [sys.executable, "-m", "vqa_project_tpu_torch.cli.serve",
         *_flags(data, path, "--device", "cpu", "--port", "0")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        for line in proc.stdout:
            if line.startswith("serving on "):
                url = line.split()[2]
                break
        else:
            pytest.fail(f"the server exited with {proc.wait(timeout=10)}")
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            assert json.load(r)["ok"] is True
        req = urllib.request.Request(url + "/predict", data=json.dumps(
            {"question": "what color is it", "image_id": ids[0]}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            assert isinstance(json.load(r)["answer"], str)
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()


def test_cuda_without_a_card_raises(checkpoint, monkeypatch):
    data, path, _ = checkpoint
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = serve.input_args(_flags(data, path))
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.build_server(args)
    with pytest.raises(FileNotFoundError):
        serve.build_server(serve.input_args(
            _flags(data, path + ".missing", "--device", "cpu")))


def _printed_json(out: str) -> dict:
    return json.loads(out[out.index("{"):])


def test_validate_parity_matches_jax(checkpoint, tmp_path, monkeypatch,
                                     capsys):
    """Both parity CLIs on one reference .pt, in float32 (both CLIs' model
    configs taken to float32 here; they compute in bfloat16 otherwise):
    the same accuracy, answer count and distinct answers, and adjacency
    statistics within 1e-4."""
    data, path, _ = checkpoint
    pt = str(tmp_path / "ref.pt")
    export_torch.main([path, pt])
    monkeypatch.chdir(tmp_path)
    common = ["--model_path", pt, "--data_dir",
              os.path.join(data, "synthetic"), "--split", "val", "--bsize",
              "16", *MODEL_FLAGS]
    for module in (j_config, p_config):
        monkeypatch.setattr(module, "ModelConfig", functools.partial(
            module.ModelConfig, compute_dtype="float32"))
    capsys.readouterr()
    j_parity.main(common)
    want = _printed_json(capsys.readouterr().out)
    validate_parity.main([*common, "--device", "cpu"])
    got = _printed_json(capsys.readouterr().out)
    assert set(got) == set(want)
    for key in ("split", "vqa_accuracy_pct", "reference_published_pct",
                "n_questions", "unique_answers_predicted"):
        assert got[key] == want[key], key
    for key in ("adjacency_mean_abs", "adjacency_row_sum_std"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
    assert os.path.exists("result.json")
