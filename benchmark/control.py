"""Readings that set the limits of ``correct``, on the card at a cell's
own size: ``python3 -m benchmark.control --workload <cell> --seeds
a,b,c --mode program|control [--seconds s]``.

``fault``: the cell's own run with a fault planted in the program
(``--fault``): ``half_batch``, each train step on the first half of its
batch; ``unchanged``, a train step that leaves the weights as they were;
``altered_answer``, one embedding of every answer batch altered where it
is produced.

``program``: the cell's own run (the entry, its window of ``--seconds``,
the comparison) on each seed in one process; the largest reading over
sound seeds is the lower end of a limit. ``control``: what a step down in
precision reads. For the embed and serve cells the reference itself is
put in the program's place, computed in the precision below the one the
configuration states (``control`` in the configuration file: fp8 under
CAM++'s bf16 kernels, bf16 under ERes2Net's TF32), on the cell's own
inputs, as many as a run compares. For the train cell it is the
program's own bf16 autocast path (``train_conf.enable_amp``) through the
cell's run. Prints one JSON line per seed: each number compared, its
limit from the configuration file, and ``correct`` as a run of the cell
decides it (``core.correct``): a control or a fault has to read false."""

import argparse
import json
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from . import core
from .entries import common
from .trace import Spans


def cell_of(workload):
    """The configuration and traffic of a cell of ``BENCHMARK.json``, or of
    ``<config>.<traffic>`` files that are not a cell yet."""
    if workload in {w["name"] for w in core.spec()["workloads"]}:
        return core.cell_files(workload)[2:]
    return core.files(*workload.split(".", 1))


def contexts(workload, seeds, seconds, traffic_over=None):
    config, traffic = cell_of(workload)
    traffic = dict(traffic, **(traffic_over or {}))
    for seed in seeds:
        yield core.Context(config, traffic, seed, seconds, False,
                           torch.device("cuda", 0), Spans(), tempfile.mkdtemp(),
                           time.perf_counter())


def program(workload, seeds, seconds, traffic_over=None):
    for ctx in contexts(workload, seeds, seconds, traffic_over):
        try:
            out = core.entry(ctx.traffic["entry"]).run(ctx)
            out.free()
            torch.cuda.empty_cache()
            compared = out.check()
        finally:
            shutil.rmtree(ctx.tmpdir, ignore_errors=True)
        yield ctx.seed, compared


def control_inputs(ctx):
    """The inputs a run of the cell compares: the embed pool, or the
    served form of the clips a serve run samples."""
    t = ctx.traffic
    if t["entry"] == "http_open_loop":
        lens, waves, _ = common.clip_pool(ctx, t["distinct_clips"])
        host = waves.cpu().numpy()
        keep = np.random.default_rng([ctx.seed, 6]).choice(len(lens), min(t["sample"], len(lens)), replace=False)
        padded = t["padded_samples"]
        w = np.zeros((len(keep), padded), np.float32)
        r = np.zeros(len(keep), np.float32)
        for j, c in enumerate(keep):
            pcm = np.clip(np.round(host[c, :lens[c]] * 32767.0), -32768, 32767).astype(np.int16)
            x = common.served_input(pcm, ctx.config["run"]["dataset_conf"]["dataset"]["target_dB"])
            w[j, :len(x)] = x
            r[j] = len(x) / padded
        return torch.from_numpy(w).to(ctx.device), r
    _, waves, ratios = common.clip_pool(ctx, t["batch"] * t["pool_batches"])
    return waves, ratios


def control(workload, seeds, seconds):
    config, traffic = cell_of(workload)
    if traffic["entry"] == "train_loop":
        yield from program(workload, seeds, seconds, {"amp": True})
        return
    for ctx in contexts(workload, seeds, seconds):
        shutil.rmtree(ctx.tmpdir, ignore_errors=True)
        state = common.seeded_state(ctx)
        waves, ratios = control_inputs(ctx)
        ref = common.reference_embeddings(config, state, waves, ratios)
        low = common.reference_embeddings(config, state, waves, ratios,
                                          config["control"])
        value = float(common.rel_err(low, ref).max())
        yield ctx.seed, [("embed_rel_err", value, core.limit(config, "embed_rel_err"))]


FAULTS = ("half_batch", "unchanged", "altered_answer")


def plant(fault, setattr=setattr):
    """Patch the program so that every later run has ``fault`` (tests pass
    ``monkeypatch.setattr``)."""
    from voiceprintrecognition_paddlepaddle_torch import predict, trainer
    if fault == "half_batch":
        step = trainer.Trainer.train_step

        def half(self, kind, data, labels, lens):
            h = data.shape[0] // 2
            return step(self, kind, data[:h], labels[:h], lens[:h])
        setattr(trainer.Trainer, "train_step", half)
    elif fault == "unchanged":
        def no_update(optimizer, schedule, step, accum_steps=1):
            optimizer.zero_grad(set_to_none=True)
            return False
        setattr(trainer, "scheduled_step", no_update)
    elif fault == "altered_answer":
        make = predict.make_campplus_masked_embed_fn
        embed_plain = predict.Predictor._embed_plain

        def altered(out):
            out = out.clone()
            out[0] = -out[0]
            return out

        def make_altered(*a, **k):
            fn = make(*a, **k)
            return lambda *x, **y: altered(fn(*x, **y))
        setattr(predict, "make_campplus_masked_embed_fn", make_altered)
        setattr(predict.Predictor, "_embed_plain",
                lambda *a, **k: altered(embed_plain(*a, **k)))
    else:
        raise ValueError(f"unknown fault {fault!r}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", choices=("program", "control", "fault"), required=True)
    p.add_argument("--fault", choices=FAULTS)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the readings need a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.mode == "fault":
        plant(args.fault)
    fn = control if args.mode == "control" else program
    for seed, compared in fn(args.workload, seeds, args.seconds):
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "fault": args.fault, "seed": seed,
                          "values": {n: v for n, v, _ in compared},
                          "limits": {n: lim for n, _, lim in compared},
                          "correct": core.correct(compared)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
