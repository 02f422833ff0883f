"""Offline embedding through the kernel path's embed function: the one
``Predictor`` builds for the stock CAM++ (``Predictor._embed``, which
``predict_batch``, ``Trainer.evaluate`` and diarization call once per
batch), on padded batches staged on the device at set-up.

Traffic keys: ``batch``, ``pool_batches`` (distinct seeded batches the
window cycles through), ``padded_samples``, ``clip_seconds``, ``level_db``,
``ahead`` (batches dispatched ahead of the device), ``max_batch_rate``
(batches a second the window may reach: the size of the outputs' host
buffer). The window dispatches batches with no sync per batch and copies
every output, asynchronously, into a pinned host buffer allocated at
set-up (keeping them on the card would allocate inside the window);
afterwards each output is compared with the reference's embeddings of its
batch."""

import time

import torch

from .. import core
from . import common


def run(ctx):
    t = ctx.traffic
    b, n_pool = t["batch"], t["pool_batches"]
    state = common.seeded_state(ctx)
    pred = common.predictor(ctx, state)
    embed = pred._embed
    if embed is None:
        raise RuntimeError("the configuration is not on the kernel path")
    lens, waves, ratios = common.clip_pool(ctx, b * n_pool)
    batches = [(waves[i * b:(i + 1) * b], ratios[i * b:(i + 1) * b])
               for i in range(n_pool)]
    for w, r in batches:             # warm-up: every batch of the pool once
        embed(w, r)
    common.sync(ctx.device)
    cap = int(ctx.seconds * t["max_batch_rate"]) + n_pool
    dim = ctx.config["run"]["model_conf"]["model_args"]["embd_dim"]
    host = torch.empty((cap, b, dim), pin_memory=ctx.device.type == "cuda")
    ahead = common.Ahead(t.get("ahead", 4), ctx.device)

    def step(i):
        if i == cap:
            raise RuntimeError(f"more than {cap} batches in the window: "
                               f"raise max_batch_rate")
        w, r = batches[i % n_pool]
        host[i].copy_(embed(w, r), non_blocking=True)
        ahead.dispatched()

    setup_s = time.perf_counter() - ctx.t0
    reading = {"config": ctx.config}
    if ctx.trace:
        from ..trace import traced
        with traced(ctx.spans, reading):
            calls, seconds = common.window_loop(ctx.seconds, step, ctx.device)
    else:
        calls, seconds = common.window_loop(ctx.seconds, step, ctx.device)
    padded = t["padded_samples"]
    work = [(lens[(i % n_pool) * b:(i % n_pool + 1) * b], padded)
            for i in range(calls)]
    reading.update(work=work, window_s=seconds, spans=ctx.spans.times,
                   counters={"utterances": calls * b})
    e2e = {"embed_utt_per_s": core.rate(calls * b, seconds)}

    def free():
        nonlocal pred, embed, batches
        pred = embed = batches = None

    def check():
        ref = common.reference_embeddings(ctx.config, state, waves, ratios).cpu()
        errs = [common.rel_err(host[i], ref[(i % n_pool) * b:(i % n_pool + 1) * b]).max()
                for i in range(calls)]
        return [("embed_rel_err", float(max(errs)), core.limit(ctx.config, "embed_rel_err"))]

    return core.Outcome(setup_s, e2e, calls * b, 0, reading, free, check)

