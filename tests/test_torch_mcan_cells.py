"""The benchmark's MCAN-large cell, run on the CPU at small sizes:
``mcan_large.train`` ``correct`` against its plain reference in float32,
its fp8 control failed, its readers of the program's counts; the
operation counts at MCAN-large's published widths; and the reference's
isolation from the port and JAX.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import run as runner
from portbench.counts import mcan as counts
from portbench.harness import cell as cellmod
from portbench.harness.mcan import n_params, program_config

ROOT = Path(__file__).resolve().parent.parent
SEED = 3_000_000_019
MCAN_SMALL = {
    "model": {"vocab_size": 50, "word_embed_size": 16, "img_feat_size": 40,
              "img_feat_pad_size": 12, "max_token": 14, "hidden_size": 32,
              "multi_head": 8, "hidden_size_head": 4, "ff_size": 128,
              "layer": 6, "flat_mlp_size": 512, "flat_glimpses": 1,
              "flat_out_size": 64, "answer_size": 30, "regions": [3, 12],
              "compute_dtype": "float32"},
    "data": {"train": {"images": 48, "questions": 256}},
    "workload": {"batch_size": 8, "warmup_steps": 4, "log_interval": 4,
                 "trace_steps": 4}}
LARGE = json.loads((ROOT / "portbench/configs/mcan_large.json").read_text())


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


def _run(name, small, trace=False, control=None):
    cell = cellmod.load(name, overrides=small)
    return runner.run(cell, SEED, 0.5, trace, "cpu", control=control)


def test_the_mcan_cell_is_correct_and_reads_its_counts():
    out = _run("mcan_large.train", MCAN_SMALL, trace=True)
    assert out["correct"] and out["attempted"] > 0
    got = out["metrics"]
    share = got["mcan.padded_row_share"]["value"]
    # regions uniform on 3..12 of 12, tokens 3-13 of 14
    assert 25.0 < share < 60.0
    # no device: the device readers and the graph's find nothing
    for name in ("mcan.products.device_ms", "mcan.products.roofline",
                 "train.graph_share", "mfu.train"):
        assert name not in got


def test_the_mcan_cells_fp8_control_is_not_correct():
    out = _run("mcan_large.train", MCAN_SMALL, control="fp8")
    assert not out["correct"]
    assert out["checks"]["logit_gap"]["value"] > 0.02


def test_mcan_counts_at_the_published_widths():
    m = LARGE["model"]
    # the program takes every published width (program_config refuses
    # one it fixes otherwise)
    assert program_config(m)["hid_dim"] == 1024
    full = counts.live_sums(np.full(4, 14), np.full(4, 100), 1)
    fwd = sum(p.flops for p in counts.products(m, 1, full))
    assert fwd == pytest.approx(21.08e9, rel=1e-3)
    assert n_params(m) == pytest.approx(201.55e6, rel=1e-4)
    live = counts.live_sums(np.full(4, 7), np.full(4, 55), 64)
    # a step's products: the forward's, and the backward's two a product
    # but the region features' (data, no gradient)
    step = counts.model_flops(m, 64, live)
    img = 2 * 64 * 55 * 2048 * 1024
    fwd64 = sum(p.flops for p in counts.products(m, 64, live))
    assert step == pytest.approx(3 * fwd64 - img)


def test_the_references_import_neither_the_port_nor_jax():
    code = ("import sys; import portbench.reference.mcan, "
            "portbench.harness.mcan; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'vqa_project_tpu', "
            "'vqa_project_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
