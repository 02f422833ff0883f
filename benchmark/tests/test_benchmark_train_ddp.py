"""The four-card training entry's parts that need no card, on the CPU over
gloo: the rank-order gather, and a whole run of the entry at world 2 with
a narrow CAM++ whose DDP steps the reference repeats on the global batch
(the ranks' batches concatenated in rank order) within the
configuration's limits."""

import copy
import multiprocessing
import os
import tempfile
import time

import pytest
import torch

from benchmark import core
from benchmark.entries import train_ddp
from benchmark.trace import Spans
from voiceprintrecognition_paddlepaddle_torch.launch_multihost import free_port

RANK_VARS = ("VPR_COORDINATOR", "VPR_NUM_PROCESSES", "VPR_PROCESS_ID",
             "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def _gather_rank(rank, port, queue):
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                         world_size=2, rank=rank)
    try:
        waves = (torch.arange(10, dtype=torch.int16) + 100 * rank).reshape(2, 5)
        labels = torch.tensor([7, 8]) + 10 * rank
        ratios = torch.tensor([0.5, 1.0]) + rank
        got = train_ddp.gather_rank_order([waves, labels, ratios])
        try:
            train_ddp.gather_rank_order([torch.zeros(1 + rank)])
            ragged = "no error"
        except ValueError:
            ragged = "ValueError"
        queue.put((rank, [g.tolist() for g in got], [g.dtype for g in got], ragged))
    finally:
        torch.distributed.destroy_process_group()


def test_gather_rank_order_on_two_ranks():
    ctx = multiprocessing.get_context("spawn")
    queue, port = ctx.Queue(), free_port()
    procs = [ctx.Process(target=_gather_rank, args=(r, port, queue)) for r in range(2)]
    for p in procs:
        p.start()
    results = sorted(queue.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(timeout=30)
        assert not p.is_alive() and p.exitcode == 0
    want = [[[0, 1, 2, 3, 4], [5, 6, 7, 8, 9], [100, 101, 102, 103, 104],
              [105, 106, 107, 108, 109]], [7, 8, 17, 18], [0.5, 1.0, 1.5, 2.0]]
    for rank, got, dtypes, ragged in results:
        assert got == want
        assert dtypes == [torch.int16, torch.int64, torch.float32]
        assert ragged == "ValueError"


def test_a_two_rank_run_steps_the_global_batch(monkeypatch):
    """Narrow CAM++ (init 16, growth 16), 0.5 s crops, b2 a rank: the
    entry's own set-up, gather, window and stop, then its check."""
    for k in RANK_VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # the child rank's threads
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    config, traffic = core.files("campplus", "train_ddp4_b64")
    config = copy.deepcopy(config)
    run = config["run"]
    run["model_conf"]["model_args"] = dict(embd_dim=192, growth_rate=16, bn_size=2,
                                           init_channels=16)
    run["model_conf"]["classifier"]["num_speakers"] = 10
    run["train_conf"]["log_interval"] = 2
    run["dataset_conf"]["dataset"]["max_duration"] = 0.5
    traffic = dict(traffic, ranks=2, batch=2, num_workers=1, clips=8, repeat=2,
                   checked_steps=2, warmup_steps=2, clip_seconds=[0.6, 1.0])
    with tempfile.TemporaryDirectory() as tmp:
        ctx = core.Context(config, traffic, 2 ** 33 + 5, 0.01, False, torch.device("cpu"),
                           Spans(), tmp, time.perf_counter())
        try:
            out = core.entry("train_ddp").run(ctx)
            out.free()
            compared = out.check()
        finally:
            torch.set_num_threads(n)
    assert not torch.distributed.is_initialized()
    assert not any(k in os.environ for k in RANK_VARS)
    assert out.reading["counters"]["batch"] == 4
    # the window ends at the first log step after its 0.01 s
    assert out.attempted in (1, 2)
    assert out.e2e["train_utt_per_s"] > 0
    assert core.correct(compared), compared
    assert [name for name, _, _ in compared] == ["loss_gap", "grad_gap", "update_gap",
                                                 "loader_mismatch_rows"]


@pytest.mark.parametrize("world", [2, 4])
def test_rank_variables(world):
    env = train_ddp._rank_env("127.0.0.1:1234", world, world - 1)
    assert env == {"VPR_COORDINATOR": "127.0.0.1:1234", "VPR_NUM_PROCESSES": str(world),
                   "VPR_PROCESS_ID": str(world - 1), "LOCAL_RANK": str(world - 1),
                   "LOCAL_WORLD_SIZE": str(world)}
