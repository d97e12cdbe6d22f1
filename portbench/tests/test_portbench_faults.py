"""The comparison that decides ``correct`` fails what it must.

Each run skips the harness's look for a card and drives the rest of a
run on the CPU (the program's plain versions) at the configuration's
published widths, with the cell's own limits and a small scale (few
images, questions, steps and requests): once with the timed path broken
underneath for each fault the cell can have (a step that leaves the
state unchanged; half of the batch left out, the mean taken over the
rest; an answer altered where it is produced), and once with the
control, the reference computed with fp8 operands in the program's
place. A one-card cell has no exchange between chips to leave out.
"""

import time

import pytest
import torch

from portbench import run as runner
from portbench.harness import cell as cellmod

SEED = 3_000_000_019          # past 32 signed bits, as the driver's are
SMALL = {
    "data": {"train": {"images": 48, "questions": 256},
             "val": {"images": 48, "questions": 512}},
    "workload": {"batch_size": 8, "warmup_steps": 4, "log_interval": 4,
                 "questions_per_call": 256, "warmup_batches": 1},
}
CASES = [("vqa2.train", "fault", "unchanged"),
         ("vqa2.train", "fault", "halfbatch"),
         ("vqa2.train", "control", "fp8"),
         ("vqa2.eval", "fault", "answer"),
         ("vqa2.eval", "control", "fp8")]


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 4))
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("name,kind,what", CASES,
                         ids=[f"{c}-{w}" for c, _, w in CASES])
def test_correct_comes_out_false(name, kind, what):
    cell = cellmod.load(name, overrides=SMALL)
    out = runner.run(cell, SEED, 1.0, False, "cpu", t0=time.perf_counter(),
                     **{kind: what}, log=lambda *a: None)
    assert out["correct"] is False, out["checks"]
    over = [k for k, c in out["checks"].items()
            if not c["value"] <= c["limit"]]
    assert over, out["checks"]
