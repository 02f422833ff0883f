"""The rest of a run on the CPU at a small size, past the harness's look
for a chip: each cell's entry, its window and its comparison. A sound
run is correct; a run with a fault planted under the timed path is not:
an answer altered where it is produced (every cell that answers), a
train step that leaves its state unchanged, a train step on half its
batch with the mean over the rest."""

import tempfile
import time

import pytest
import torch

from benchmark import control, core
from benchmark.trace import Spans

SMALL = {
    "campplus.embed_4s": {"batch": 2, "pool_batches": 1},
    "eres2net.embed_4s": {"batch": 2, "pool_batches": 1},
    "campplus.serve_poisson": {"rate": 8.0, "warmup_s": 0.5, "distinct_clips": 4,
                               "sample": 8, "threads": 4},
    "campplus.train_b256": {"batch": 4, "clips": 16, "num_workers": 2,
                            "warmup_steps": 3},
}


def run_cell(workload, seconds=0.5):
    config, traffic = control.cell_of(workload)
    torch.set_num_threads(4)
    ctx = core.Context(config, dict(traffic, **SMALL[workload]), 2 ** 31 + 99,
                       seconds, False, torch.device("cpu"), Spans(),
                       tempfile.mkdtemp(), time.perf_counter())
    out = core.entry(ctx.traffic["entry"]).run(ctx)
    out.free()
    return out, out.check()


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(workload):
    out, compared = run_cell(workload)
    assert core.correct(compared), compared
    assert out.attempted > 0 and out.failed == 0
    assert out.setup_s > 0 and all(v > 0 for v in out.e2e.values())


@pytest.mark.parametrize("workload", ["campplus.embed_4s", "eres2net.embed_4s",
                                      "campplus.serve_poisson"])
def test_altered_answer_is_caught(workload, monkeypatch):
    control.plant("altered_answer", monkeypatch.setattr)
    _, compared = run_cell(workload)
    assert not core.correct(compared), compared


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_train_faults_are_caught(fault, monkeypatch):
    control.plant(fault, monkeypatch.setattr)
    _, compared = run_cell("campplus.train_b256")
    assert not core.correct(compared), compared
