"""Offline embedding through the user's call, ``Predictor.predict_batch``
on numpy clips: padding on the host, the copy, the model, ``.cpu()``.

Traffic keys: ``batch`` (clips a call, and its ``batch_size``),
``pool_batches``, ``padded_samples`` (the bucket every clip of the mix
pads to), ``clip_seconds``, ``level_db``. The window calls
``predict_batch`` on the pool's batches in turn and keeps every answer;
afterwards each is compared with the reference's embeddings of its
clips, padded to the same bucket."""

import time

import numpy as np
import torch

from .. import core
from . import common


def run(ctx):
    t = ctx.traffic
    b, n_pool = t["batch"], t["pool_batches"]
    state = common.seeded_state(ctx)
    pred = common.predictor(ctx, state)
    lens, waves, ratios = common.clip_pool(ctx, b * n_pool)
    host = waves.cpu().numpy()
    clips = [host[i, :n] for i, n in enumerate(lens)]
    batches = [clips[i * b:(i + 1) * b] for i in range(n_pool)]
    predict = ctx.spans.wrap("predict_batch", pred.predict_batch)
    for c in batches:                 # warm-up: every batch of the pool once
        predict(c, batch_size=b)
    common.sync(ctx.device)
    outs = []

    def step(i):
        outs.append((i % n_pool, predict(batches[i % n_pool], batch_size=b)))

    ctx.spans.times.clear()
    setup_s = time.perf_counter() - ctx.t0
    reading = {"config": ctx.config}
    if ctx.trace:
        from ..trace import traced
        with traced(ctx.spans, reading):
            calls, seconds = common.window_loop(ctx.seconds, step, ctx.device)
    else:
        calls, seconds = common.window_loop(ctx.seconds, step, ctx.device)
    padded = t["padded_samples"]
    reading.update(work=[(lens[k * b:(k + 1) * b], padded) for k, _ in outs],
                   window_s=seconds, spans=ctx.spans.times,
                   counters={"utterances": calls * b})
    e2e = {"predict_utt_per_s": core.rate(calls * b, seconds)}

    def free():
        nonlocal pred, predict
        pred = predict = None

    def check():
        ref = common.reference_embeddings(ctx.config, state, waves, ratios)
        errs = [common.rel_err(torch.from_numpy(np.asarray(out)), ref[k * b:(k + 1) * b].cpu()).max()
                for k, out in outs]
        return [("embed_rel_err", float(max(errs)), core.limit(ctx.config, "embed_rel_err"))]

    return core.Outcome(setup_s, e2e, calls * b, 0, reading, free, check)
