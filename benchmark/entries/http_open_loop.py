"""``/embedding`` served over HTTP in this process, loaded by an open
loop of arrivals from a child process (``loadgen``).

Set-up builds ``Predictor`` on the seeded weights, a ``MicroBatcher``
(``window_ms``, ``max_batch``) and a ``ServingHTTPServer`` on a free port
of localhost, as a deployment of ``serve.py`` with ``--dynamic_batch_ms``
runs them, and writes the traffic's clips as 16-bit PCM WAV bodies. The
child warms the server with ``warmup_s`` of the same arrivals, then runs
the window: ``rate`` requests a second for ``--seconds``, the gaps the
stratified quantiles of an exponential (Poisson arrivals), the same set
for every seed in an order the seed draws. Latency is timed from when a
request was due; a failed request counts as a miss at the window's
length. Afterwards a sample of the answers, drawn from the seed, is
compared with the reference's embeddings of the same decoded clips.

Traffic keys: ``rate``, ``warmup_s``, ``distinct_clips``, ``clip_seconds``,
``padded_samples``, ``level_db``, ``window_ms``, ``max_batch``,
``threads`` (the child's senders), ``sample`` (answers compared)."""

import contextlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from .. import core
from . import common


def schedule(rate, seconds, n_clips, seed, salt):
    """(due seconds, clip index) of ``round(rate * seconds)`` arrivals."""
    n = max(1, int(round(rate * seconds)))
    rng = np.random.default_rng([seed, salt])
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    due = np.cumsum(rng.permutation(gaps)) - gaps.min()
    clips = rng.integers(0, n_clips, n)
    return [[float(d), int(c)] for d, c in zip(due, clips)]


class Serving:
    """The server, its batcher and the clips, built once; ``window``
    runs one child over one schedule and may be called again (the knee
    sweep does)."""

    def __init__(self, ctx):
        from voiceprintrecognition_paddlepaddle_torch.infer_utils.micro_batcher import MicroBatcher
        from voiceprintrecognition_paddlepaddle_torch.serve import ServingHTTPServer, make_handler
        t = ctx.traffic
        self.ctx = ctx
        self.state = common.seeded_state(ctx)
        self.pred = common.predictor(ctx, self.state)
        self.pred.predict_batch = ctx.spans.wrap("predict_batch", self.pred.predict_batch)
        self.batcher = MicroBatcher(self.pred, window_ms=t["window_ms"],
                                    max_batch=t["max_batch"])
        self.server = ServingHTTPServer(("127.0.0.1", 0),
                                        make_handler(self.pred, self.batcher))
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.lens, waves, _ = common.clip_pool(ctx, t["distinct_clips"])
        host = waves.cpu().numpy()
        self.pcm = [np.clip(np.round(host[i, :n] * 32767.0), -32768, 32767)
                    .astype(np.int16) for i, n in enumerate(self.lens)]
        bodies = [common.wav_body(p) for p in self.pcm]
        self.bodies_path = os.path.join(ctx.tmpdir, "bodies.bin")
        with open(self.bodies_path, "wb") as f:
            f.write(b"".join(bodies))
        self.offsets = [0] + np.cumsum([len(b) for b in bodies]).tolist()

    def window(self, rate, seconds, seed, keep=(), warmup_s=None, on_go=None,
               around=None):
        """Run the child: warm-up, then the window (``on_go()`` first, and
        inside the context manager ``around`` if given). Returns the
        child's result."""
        t = self.ctx.traffic
        n_clips = len(self.pcm)
        warm = warmup_s if warmup_s is not None else t["warmup_s"]
        plan = {"port": self.server.server_address[1],
                "bodies": self.bodies_path, "offsets": self.offsets,
                "warmup": schedule(rate, warm, n_clips, seed, 2),
                "window": schedule(rate, seconds, n_clips, seed, 3),
                "threads": t["threads"], "timeout_s": seconds + 60.0,
                "keep": list(keep)}
        path = os.path.join(self.ctx.tmpdir, "plan.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(plan, f)
        child = subprocess.Popen(
            [sys.executable, "-m", "benchmark.entries.loadgen", path],
            cwd=core.ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True)
        try:
            if child.stdout.readline().strip() != "ready":
                raise RuntimeError("the load generator did not start")
            if on_go is not None:
                on_go()
            with around or contextlib.nullcontext():
                child.stdin.write("go\n")
                child.stdin.flush()
                line = child.stdout.readline()
        finally:
            child.stdin.close()
            child.wait(timeout=120)
        if not line:
            raise RuntimeError(f"the load generator exited with {child.returncode}")
        out = json.loads(line)
        out["plan"] = plan["window"]
        return out

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()


def summarize(res, seconds):
    """(p95 ms over every request due, failed, backlog: the median
    latency of the last fifth over that of the first fifth, the
    generator's p99 lateness ms)."""
    lat = [seconds * 1e3 if v is None else v for v in res["latency_ms"]]
    failed = sum(v is None for v in res["latency_ms"])
    k = max(1, len(lat) // 5)
    backlog = core.quantile(lat[-k:], 0.5) / core.quantile(lat[:k], 0.5)
    return (core.quantile(lat, 0.95), failed, backlog,
            core.quantile(res["late_ms"], 0.99))


def run(ctx):
    t = ctx.traffic
    srv = Serving(ctx)
    n = max(1, int(round(t["rate"] * ctx.seconds)))
    keep = np.sort(np.random.default_rng([ctx.seed, 4]).choice(
        n, min(t["sample"], n), replace=False)).tolist()
    reading = {"config": ctx.config}
    counts = {}
    marks = {}

    def go():
        ctx.spans.times.clear()
        counts["items0"], counts["batches0"] = srv.batcher.items, srv.batcher.batches
        marks["setup_s"] = time.perf_counter() - ctx.t0

    around = None
    if ctx.trace:
        from ..trace import traced
        around = traced(ctx.spans, reading)
    res = srv.window(t["rate"], ctx.seconds, ctx.seed, keep, on_go=go,
                     around=around)
    p95, failed, backlog, late = summarize(res, ctx.seconds)
    items = srv.batcher.items - counts["items0"]
    batches = srv.batcher.batches - counts["batches0"]
    print(f"serve: {len(res['latency_ms'])} requests, p95 {p95:.3f} ms, "
          f"failed {failed}, backlog {backlog:.3f}, generator p99 late "
          f"{late:.3f} ms, {items} items in {batches} batches",
          file=sys.stderr, flush=True)
    reading.update(spans=dict(ctx.spans.times), counters={
        "items": items, "batches": batches}, window_s=res["span_s"])
    e2e = {"request_p95_ms": p95}

    def free():
        srv.close()
        srv.pred = srv.batcher = None

    def check():
        got = res["embeddings"]
        if not got:
            return [("embed_rel_err", float("inf"), core.limit(ctx.config, "embed_rel_err"))]
        idx = sorted(got, key=int)
        clips = sorted({res["plan"][int(i)][1] for i in idx})
        row = {c: j for j, c in enumerate(clips)}
        padded = t["padded_samples"]
        w = np.zeros((len(clips), padded), np.float32)
        r = np.zeros(len(clips), np.float32)
        for j, c in enumerate(clips):
            x = common.served_input(srv.pcm[c], ctx.config["run"]["dataset_conf"]["dataset"]["target_dB"])
            w[j, :len(x)] = x
            r[j] = len(x) / padded
        ref = common.reference_embeddings(ctx.config, srv.state,
                                          torch.from_numpy(w).to(ctx.device), r)
        served = torch.tensor([got[i] for i in idx], dtype=torch.float64)
        want = ref[[row[res["plan"][int(i)][1]] for i in idx]].cpu()
        err = float(common.rel_err(served, want).max())
        return [("embed_rel_err", err, core.limit(ctx.config, "embed_rel_err"))]

    return core.Outcome(marks["setup_s"], e2e, len(res["latency_ms"]), failed,
                        reading, free, check)
