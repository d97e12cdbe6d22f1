"""The benchmark's Nemotron-3-Nano cell, run on the CPU at small sizes:
``nemotron3_nano.train`` ``correct`` against its plain reference in
float32 with its MoE readers, its fp8 control failed; the configuration
against the published one, the counts at the published widths; and the
reference's isolation from the port and JAX.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import run as runner
from portbench.counts import mcan as live_counts
from portbench.counts import nemotron_h as counts
from portbench.harness import cell as cellmod
from portbench.harness.nemotron import n_params, program_config, spec

ROOT = Path(__file__).resolve().parent.parent
SEED = 3_000_000_026
SMALL = {
    "model": {"hidden_size": 32, "mamba_num_heads": 4, "mamba_head_dim": 8,
              "ssm_state_size": 8, "n_groups": 2, "chunk_size": 16,
              "router_experts": 16, "n_routed_experts": 4,
              "first_held_expert": 0, "num_experts_per_tok": 3,
              "moe_intermediate_size": 24,
              "moe_shared_expert_intermediate_size": 40,
              "num_attention_heads": 4, "num_key_value_heads": 2,
              "head_dim": 8, "vocab_size": 50, "img_feat_size": 40,
              "img_feat_pad_size": 12, "answer_size": 30, "regions": [3, 12],
              "compute_dtype": "float32"},
    "data": {"train": {"images": 48, "questions": 256}},
    "workload": {"batch_size": 8, "warmup_steps": 4, "log_interval": 4,
                 "trace_steps": 4, "rows_at_once": 4}}
CONFIG = json.loads(
    (ROOT / "portbench/configs/nemotron3_nano.json").read_text())
CATALOG = {  # the source's config.json, as the configuration states it
    "hybrid_override_pattern":
        "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME",
    "num_hidden_layers": 52, "n_routed_experts": 128, "vocab_size": 131072}


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


def _run(trace=False, control=None):
    cell = cellmod.load("nemotron3_nano.train", overrides=SMALL)
    return runner.run(cell, SEED, 0.5, trace, "cpu", control=control)


def test_the_nemotron_cell_is_correct_and_reads_its_moe_counts():
    out = _run(trace=True)
    assert out["correct"] and out["attempted"] > 0, out["checks"]
    assert out["checks"]["route_mismatch"]["value"] == 0.0
    got = out["metrics"]
    # 4 of 16 experts held
    assert 10.0 < got["moe.held_row_share"]["value"] < 45.0
    assert got["moe.load_imbalance"]["value"] >= 1.0
    # the loader's padding of the 12 + 14 positions: regions uniform on
    # 3..12, tokens 3-13
    assert 25.0 < got["mcan.padded_row_share"]["value"] < 65.0
    # no device: the device readers and the graph's find nothing
    for name in ("moe.expert_gemm.device_ms", "moe.expert_gemm.roofline",
                 "nemotron.products.device_ms", "nemotron.products.roofline",
                 "train.graph_share", "mfu.train"):
        assert name not in got


def test_the_nemotron_products_readers_leave_the_grouped_kernel_out():
    cell = cellmod.load("nemotron3_nano.train")
    rec = {"family": "train", "busy_s": 1.0, "traced_units": 10,
           "nemotron_products_least_s": 0.003,
           "device_ops": [["nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", 0.004],
                          ["void cutlass::Kernel2<cutlass_80_wmma>()", 0.002],
                          ["void (anonymous namespace)::grouped_kernel<256, 1,"
                           " 1>(CUtensorMap, CUtensorMap)", 0.5],
                          ["void at::native::elementwise_kernel<128, 4>()",
                           0.3]]}
    device_ms = cell.reader("nemotron.products.device_ms").read(rec)
    roofline = cell.reader("nemotron.products.roofline").read(rec)
    assert device_ms == pytest.approx(1e3 * 0.006 / 10)
    assert roofline == pytest.approx(50.0)
    # another family's record, or one without the count, reads nothing
    assert cell.reader("nemotron.products.roofline").read(
        {**rec, "family": "eval"}) is None
    del rec["nemotron_products_least_s"]
    assert cell.reader("nemotron.products.device_ms").read(rec) is None


def test_the_nemotron_cells_fp8_control_is_not_correct():
    out = _run(control="fp8")
    assert not out["correct"]
    limits = cellmod.load("nemotron3_nano.train").workload["limits"]
    assert any(out["checks"][k]["value"] > limits[k] for k in limits)


def test_the_configuration_is_the_published_one_but_its_cut():
    cut = {k: v["published"] for k, v in CONFIG["reduced"].items()}
    assert cut == CATALOG
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "nemotron3_nano")
    assert sorted(entry["reduced"]) == sorted(CONFIG["reduced"])
    m = spec(CONFIG)
    assert (m["hidden_size"], m["moe_intermediate_size"],
            m["mamba_num_heads"] * m["mamba_head_dim"]) == (2688, 1856, 4096)
    sizes = program_config(m)["arch_sizes"]
    assert (sizes["n_routed_experts"], sizes["n_held_experts"]) == (128, 16)
    assert m["hybrid_override_pattern"] == CATALOG[
        "hybrid_override_pattern"][:13]


def test_nemotron_counts_at_the_published_widths():
    m = spec(CONFIG)
    assert n_params(m) == pytest.approx(1.2539e9, rel=1e-3)
    # every sequence whole: 100 regions and 14 tokens, B = 64
    full = live_counts.live_sums(np.full(4, 14), np.full(4, 100), 64)
    held = 64 * 114 * 6 * 16 / 128
    prods = counts.products(m, 64, full, held)
    fwd = sum(p.flops for p in prods)
    assert fwd == pytest.approx(6.30e12, rel=1e-2)

    def kind(k):
        return sum(p.flops for p in prods for i, c in
                   enumerate(counts.kinds(m))
                   if c == k and p.name.startswith(f"layer{i}."))

    assert kind("M") == pytest.approx(3.41e12, rel=1e-2)
    assert kind("*") == pytest.approx(0.70e12, rel=1e-2)
    # the products a step: the forward's, and the backward's two a product
    # but the region features' (data, no gradient)
    proj1 = 2 * full["r1"] * 2048 * 2688
    assert counts.model_flops(m, 64, full, held) == pytest.approx(
        3 * fwd - proj1)
    # the grouped kernel's six products a MoE block
    ops = counts.expert_ops(m, held)
    assert len(ops) == 6 and all(op.flops == 2 * held * 2688 * 1856
                                 for op in ops)
    # the library's products are every product but the held experts'
    experts = [op for op in counts.product_ops(m, 64, full, held)
               if ".experts_" in op.name]
    assert len(experts) == 5 * 2 * 3
    assert counts.library_least_seconds(m, 64, full, held) == pytest.approx(
        counts.least_seconds(counts.product_ops(m, 64, full, held))
        - counts.least_seconds(experts))


def test_the_references_import_neither_the_port_nor_jax():
    code = ("import sys; import portbench.reference.nemotron_h, "
            "portbench.harness.nemotron, portbench.counts.nemotron_h; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'vqa_project_tpu', "
            "'vqa_project_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
