"""A traced run measures its window as an untraced one does and profiles
after it; the readers put the trace's device time per unit of work over
the untraced window's time per unit, never over the profiled stretch's."""

import time

import pytest
import torch

from portbench import run as runner
from portbench.counts import peaks
from portbench.harness import cell as cellmod

SEED = 3_000_000_019
SMALL = {
    "data": {"train": {"images": 48, "questions": 256},
             "val": {"images": 48, "questions": 512}},
    "workload": {"batch_size": 8, "warmup_steps": 4, "log_interval": 4,
                 "trace_steps": 4, "questions_per_call": 256,
                 "warmup_batches": 1},
}
# a profiled stretch three times slower on the host than the window
REC = {"family": "train", "busy_s": 0.1, "window_s": 1.5, "traced_units": 40,
       "units": 400, "elapsed_s": 5.0, "unit_flops": 1e12,
       "least_s": 0.02, "span_totals": {"train_step": 4.0, "data_wait": 0.4},
       "device_ops": [("multi_tensor_apply_kernel<x>", 0.04), ("gemm", 0.06)]}


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 4))
    yield
    torch.set_num_threads(old)


def _read(name, rec, cell="vqa2.train"):
    return cellmod.load(cell).reader(name).read(rec)


def test_shares_read_the_untraced_window():
    assert _read("device.idle_share.train", REC) == pytest.approx(
        100 * (1 - (0.1 / 40) / (5.0 / 400)))
    assert _read("mfu.train", REC) == pytest.approx(
        100 * 1e12 * 400 / 5.0 / peaks.BF16_FLOPS)
    assert _read("train.issue_ms", REC) == pytest.approx(10.0)
    assert _read("train.data_wait_ms", REC) == pytest.approx(1.0)
    assert _read("adam.device_ms", REC) == pytest.approx(1.0)
    assert _read("kernels.roofline.train", REC) == pytest.approx(20.0)


@pytest.mark.parametrize("name", ["device.idle_share.eval", "mfu.eval",
                                  "kernels.roofline.eval"])
def test_readers_of_another_family_find_nothing(name):
    assert _read(name, REC, "vqa2.eval") is None


@pytest.mark.parametrize("name,units", [("vqa2.train", "steps"),
                                        ("vqa2.eval", "calls")])
def test_traced_run_profiles_after_the_window(name, units):
    cell = cellmod.load(name, overrides=SMALL)
    out = runner.run(cell, SEED, 1.0, True, "cpu", t0=time.perf_counter(),
                     log=lambda *a: None)
    rec = out["records"]
    assert out["correct"] is True, out["checks"]
    assert rec["elapsed_s"] >= 1.0 and rec["units"] >= 1
    assert rec["traced_units"] == (4 if units == "steps" else 1)
    if units == "steps":
        assert set(rec["span_totals"]) >= {"data_wait", "train_step"}
        assert 0 < rec["span_totals"]["train_step"] <= rec["elapsed_s"]
        assert {n for n, _, _ in rec["spans"]} >= {"data_wait", "train_step"}
