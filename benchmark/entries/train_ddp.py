"""Data-parallel training: ``train_loop``'s loop run by one rank a card in
a ``torch.distributed`` group, as the port's ``launch_multihost`` starts
its trainer: ``DistributedDataParallel`` over the step's modules, the
rank-sharded sampler, the cross-rank BatchNorm (``parallel/mesh.py``).

Rank 0 is the harness's process on its device, so that its trace and the
port's spans are read as in the one-card cell. Set-up writes the corpus
(``train_loop.write_corpus``), then starts ranks 1.. as child processes
(``python -m benchmark.entries.train_ddp <job file> <rank>``) that join
the group through the port's ``VPR_*`` variables; each child computes on
``cuda:<rank>`` (``parallel.rank_device``), or on the CPU where rank 0
does. Every rank builds ``Trainer`` on the configuration with the
traffic's per-rank ``batch``, loads the seeded weights, and steps
``checked_steps``, then up to ``warmup_steps``, then the window.

Every rank takes the same steps: the stop rides on the all-reduce of
the loss and accuracy that the trainer's own loop makes every
``log_interval`` steps in a group of more than one rank. Rank 0 sets the
flag once its window has run ``seconds``; each rank reads the reduced
values at that step (the read the trainer's loop makes on rank 0), so
no rank adds a host sync per step. ``train_utt_per_s`` counts the global
batch of every step in rank 0's window.

``correct``: after the checked steps each rank's kept batches are
gathered on every rank in rank order (``gather_rank_order``); the
reference steps their concatenation, the global batch of 256, from the
seeded state. The port's BatchNorm normalizes by the global batch in a
group and DDP averages the gradients over the ranks, so a DDP step is
the one-card step on that batch, held to the configuration's limits by
``train_loop.compare_training``; the checked losses are the global
batch's (the loss all-reduced over the ranks).

A child's failure, rank 0's, or a run past the window and ``SLACK_S``
ends every rank: rank 0 kills the children and leaves with exit code 4
(a watchdog thread does it while rank 0 may be blocked in a
collective), and a child whose parent is gone leaves too, so no run
hangs. Every rank tears the group down right after its window, before
rank 0 waits for the children to exit (``_Rank.leave``).

Traffic keys: those of ``train_loop`` (``batch`` per rank) and
``ranks``, the group's size."""

import json
import os
import subprocess
import sys
import threading
import time
import traceback

import torch

from .. import core
from ..reference.train import train_steps
from ..trace import Spans
from ..weights import reference_model, seeded_state
from . import common
from .train_loop import (compare_training, loader_mismatches, run_conf,
                         traffic_frames, write_corpus)

EXIT_RANK_FAILED = 4
# set-up, NCCL's start, the warm-up and the gather, beside the window
SLACK_S = 900.0
B1 = 0.9


def gather_rank_order(tensors):
    """Every rank's ``tensors`` (the same shapes and dtypes on each rank),
    each concatenated over dim 0 in rank order, on every rank (a
    collective). Shipped as bytes, so NCCL takes any dtype."""
    from voiceprintrecognition_paddlepaddle_torch.parallel.mesh import (
        all_gather_stacked, local_process_info)
    world = local_process_info()[1]
    out = []
    for x in tensors:
        x = x.contiguous()
        shape = torch.tensor(list(x.shape), device=x.device)
        shapes = all_gather_stacked(shape)
        if bool((shapes != shape).any()):
            raise ValueError(f"the ranks hold different shapes "
                             f"{shapes.tolist()}; a global batch needs one")
        raw = all_gather_stacked(x.reshape(-1).view(torch.uint8))
        out.append(raw.view(x.dtype).reshape((world * x.shape[0],) + tuple(x.shape[1:])))
    return out


class _Rank:
    """One rank's trainer and its loop over ``train_loop``'s steps."""

    def __init__(self, ctx, lst, world):
        from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer
        self.ctx, self.world, self.t = ctx, world, ctx.traffic
        n_cls = ctx.config["run"]["model_conf"]["classifier"]["num_speakers"]
        self.conf = run_conf(ctx, lst)
        self.state = common.seeded_state(ctx)
        self.cls_w = seeded_state({"classifier.weight": (192, n_cls)}, ctx.seed + 1,
                                  ctx.device)["classifier.weight"]
        tr = Trainer(self.conf, device=str(ctx.device))
        tr._setup_dataloader(is_train=True)
        tr._setup_model(tr.audio_featurizer.feature_dim, is_train=True)
        tr.model.load_state_dict(self.state)
        tr.classifier.load_state_dict({"weight": self.cls_w})
        tr.model.train()
        tr.classifier.train()
        self.tr = tr
        self.log_interval = self.conf["train_conf"]["log_interval"]
        self.steps_per_epoch = len(tr.train_loader)
        self.named = dict(zip(tr.param_names, tr.optimizer.param_groups[0]["params"]))
        self.feed = self._batches()
        self.losses = []
        self.stop_at = None        # rank 0: the window's end on the host clock

    def _batches(self):
        epoch = 0
        while True:
            epoch += 1
            self.tr._banks = self.tr.augmenter.device_banks(epoch, self.tr.device)
            yield from enumerate(self.tr.train_loader)

    def step(self):
        """One step; at a log step, the all-reduce of loss, accuracy and
        rank 0's stop flag. Returns ``(data, labels, lens, loss, stop)``."""
        from voiceprintrecognition_paddlepaddle_torch.parallel.mesh import all_reduce_sum
        tr = self.tr
        with self.ctx.spans.span("loader_wait"):
            batch_id, (kind, data, labs, lens) = next(self.feed)
        if tr.margin_scheduler:
            tr.margin_scheduler.step(current_step=tr.step)
        data, labs, lens = (tr._to_device(x) for x in (data, labs, lens))
        loss, acc = tr.train_step(kind, data, labs, lens)
        stop = False
        if batch_id % self.log_interval == 0:
            flag = float(self.stop_at is not None and time.perf_counter() >= self.stop_at)
            red = all_reduce_sum(torch.stack([loss.float(), acc.float(),
                                              torch.full_like(acc.float(), flag)]))
            mean_loss, _, flags = red.tolist()
            self.losses.append(mean_loss / self.world)
            stop = flags > 0
        return data, labs, lens, loss, stop

    def set_up(self):
        """The checked steps (their batches gathered over the ranks, the
        global losses, Adam's first moment after step 1, the weights
        before and after), then the warm-up."""
        from voiceprintrecognition_paddlepaddle_torch.parallel.mesh import all_reduce_sum
        t = self.t
        self.before = {k: p.detach().clone() for k, p in self.named.items()}
        kept, losses, self.first_m = [], [], None
        for k in range(t["checked_steps"]):
            data, labs, lens, loss, _ = self.step()
            kept.append((data.clone(), labs.clone(), lens.clone()))
            losses.append(all_reduce_sum(loss.float()))
            if k == 0:
                self.first_m = {n: self.tr.optimizer.state.get(p, {}).get(
                    "exp_avg", torch.zeros_like(p)).detach().float().clone()
                    for n, p in self.named.items()}
        self.after = {k: p.detach().clone() for k, p in self.named.items()}
        self.kept_loss = [float(x) / self.world for x in losses]
        self.kept = [tuple(gather_rank_order(b)) for b in kept]
        for _ in range(t["warmup_steps"] - t["checked_steps"]):
            self.step()
        common.sync(self.ctx.device)

    def window(self, seconds=None):
        """Steps until the stop, which rank 0 sets ``seconds`` after the
        start; returns (steps, seconds to the device's end)."""
        t0 = time.perf_counter()
        if seconds is not None:
            self.stop_at = t0 + seconds
        n, stop = 0, False
        while not stop:
            stop = self.step()[-1]
            n += 1
        common.sync(self.ctx.device)
        return n, time.perf_counter() - t0

    @staticmethod
    def leave():
        """Tear the group down. Every rank does so right after its window
        (all stop at the same step): NCCL's teardown waits for the peers,
        so a child that tore down while rank 0 waited for it to exit
        never exited (four H100s, NCCL)."""
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()

    def close(self):
        self.feed.close()
        self.tr = self.feed = None


def _rank_env(coordinator, world, rank):
    return {"VPR_COORDINATOR": coordinator, "VPR_NUM_PROCESSES": str(world),
            "VPR_PROCESS_ID": str(rank), "LOCAL_RANK": str(rank),
            "LOCAL_WORLD_SIZE": str(world)}


class _Children:
    """Ranks 1.. as child processes, and a watchdog over them and the run's
    deadline: on a child's failure or past the deadline it kills them all
    and ends this process."""

    def __init__(self, job, world, coordinator, timeout_s):
        self.procs = []
        for rank in range(1, world):
            env = dict(os.environ, **_rank_env(coordinator, world, rank))
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "benchmark.entries.train_ddp", job, str(rank)],
                cwd=core.ROOT, env=env, stdout=sys.stderr, stderr=sys.stderr))
        self.deadline = time.monotonic() + timeout_s
        self.done = threading.Event()
        self.watch = threading.Thread(target=self._watch, daemon=True)
        self.watch.start()

    def _watch(self):
        while not self.done.wait(0.5):
            codes = [p.poll() for p in self.procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed or time.monotonic() > self.deadline:
                why = (f"rank {codes.index(failed[0]) + 1} exited with {failed[0]}"
                       if failed else "the run passed its deadline")
                print(f"train_ddp: {why}; ending every rank", file=sys.stderr, flush=True)
                self.kill()
                os._exit(EXIT_RANK_FAILED)

    def wait(self, timeout_s):
        end = time.monotonic() + timeout_s
        for p in self.procs:
            p.wait(timeout=max(end - time.monotonic(), 0.1))
        self.done.set()
        codes = [p.returncode for p in self.procs]
        if any(codes):
            raise RuntimeError(f"ranks 1.. exited with {codes}")

    def kill(self):
        self.done.set()
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass


def run(ctx):
    from voiceprintrecognition_paddlepaddle_torch.launch_multihost import free_port
    t = ctx.traffic
    world = int(t["ranks"])
    n_cls = ctx.config["run"]["model_conf"]["classifier"]["num_speakers"]
    lst, pcm, labels = write_corpus(ctx, n_cls)
    job = os.path.join(ctx.tmpdir, "ddp_job.json")
    with open(job, "w", encoding="utf-8") as f:
        json.dump({"config": ctx.config, "traffic": t, "seed": ctx.seed,
                   "list": lst, "device": ctx.device.type, "tmpdir": ctx.tmpdir}, f)
    coordinator = f"127.0.0.1:{free_port()}"
    saved_env = {k: os.environ.get(k) for k in _rank_env("", 0, 0)}
    os.environ.update(_rank_env(coordinator, world, 0))
    children = _Children(job, world, coordinator, ctx.seconds + SLACK_S)
    reading = {"config": ctx.config}
    try:
        rank = _Rank(ctx, lst, world)
        rank.set_up()
        ctx.spans.times.clear()
        if ctx.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(ctx.device)
        setup_s = time.perf_counter() - ctx.t0
        if ctx.trace:
            from ..trace import traced
            with traced(ctx.spans, reading):
                steps, seconds = rank.window(ctx.seconds)
        else:
            steps, seconds = rank.window(ctx.seconds)
        rank.leave()
        children.wait(120.0)
    except BaseException:
        children.kill()
        raise
    global_batch = t["batch"] * world
    reading.update(spans=dict(ctx.spans.times), window_s=seconds,
                   counters={"steps": steps, "batch": global_batch,
                             "frames": traffic_frames(rank.conf)})
    e2e = {"train_utt_per_s": core.rate(steps * global_batch, seconds)}
    print(f"train_ddp: {world} ranks, {steps} steps of {global_batch} in {seconds:.3f} s, "
          f"losses {rank.losses[-3:]}", file=sys.stderr, flush=True)

    def free():
        rank.close()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def check():
        grads_prog = {n: m / (1 - B1) for n, m in rank.first_m.items()}
        model = reference_model(ctx.config)
        model.load_state_dict(rank.state)
        ref_losses, ref_grads, ref_after = train_steps(
            rank.conf, model, rank.cls_w, rank.kept, rank.steps_per_epoch)
        return compare_training(ctx.config, rank.kept_loss, grads_prog, rank.before,
                                rank.after, ref_losses, ref_grads, ref_after) + [
            ("loader_mismatch_rows", float(loader_mismatches(rank.kept, pcm, labels)),
             core.limit(ctx.config, "loader_mismatch_rows"))]

    return core.Outcome(setup_s, e2e, steps, 0, reading, free, check)


def _orphaned(parent):
    """End this process once its parent (rank 0) is gone."""
    while True:
        if os.getppid() != parent:
            os._exit(EXIT_RANK_FAILED)
        time.sleep(0.5)


def child_main(job_path, rank):
    """Rank ``rank`` of a run that rank 0 started: the same set-up and
    steps as rank 0, to the stop rank 0 sends."""
    threading.Thread(target=_orphaned, args=(os.getppid(),), daemon=True).start()
    with open(job_path, encoding="utf-8") as f:
        job = json.load(f)
    device = torch.device(job["device"])
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    ctx = core.Context(job["config"], job["traffic"], job["seed"], 0, False,
                       device, Spans(), job["tmpdir"], time.perf_counter())
    me = _Rank(ctx, job["list"], int(job["traffic"]["ranks"]))
    me.set_up()
    me.window()
    me.leave()
    me.close()


if __name__ == "__main__":
    try:
        child_main(sys.argv[1], int(sys.argv[2]))
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    sys.exit(0)
