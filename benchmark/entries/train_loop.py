"""Training: the loop of ``Trainer._train_epoch`` written here over the
user's objects: ``Trainer.train_loader``, ``Trainer._to_device``,
``Trainer.train_step``, the margin scheduler stepped before each step and
the loss read back every ``log_interval`` steps, as that loop logs it.

Set-up writes a seeded corpus of int16 WAV clips under ``TMPDIR`` with
its train list (labels drawn over the configuration's speakers; each
clip listed ``repeat`` times, so that an epoch is as many steps long as
one over a real corpus while the disk holds only the distinct clips),
builds
``Trainer`` on the configuration with the traffic's ``batch`` and
``num_workers``, loads the seeded weights into its model and classifier,
and drives the first ``checked_steps`` steps through the same loop,
keeping their batches, their losses, Adam's first moment after step 1
and the weights before step 1 and after the last of them. More steps warm
up to ``warmup_steps``; then the window. Afterwards the reference runs
the checked steps from the seeded state on the kept batches, and each
kept batch's rows are held to the corpus (the loader's crop of some clip
of the row's label, as the native loader quantizes it).

Traffic keys: ``batch``, ``num_workers``, ``clips``, ``repeat``,
``clip_seconds``, ``checked_steps``, ``warmup_steps``, ``amp`` (the trainer's bf16 autocast:
the control)."""

import copy
import os
import sys
import time

import numpy as np
import torch

from .. import core, traffic_gen
from ..reference.train import train_steps
from ..weights import reference_model, seeded_state
from . import common


def write_corpus(ctx, n_classes):
    t = ctx.traffic
    lens = traffic_gen.lengths(t, t["clips"], ctx.seed)
    labels = np.random.default_rng([ctx.seed, 5]).integers(0, n_classes, len(lens))
    root = os.path.join(ctx.tmpdir, "corpus")
    os.makedirs(root)
    pcm, lines, chunk = [], [], 256
    for i in range(0, len(lens), chunk):
        part = lens[i:i + chunk]
        w = traffic_gen.waves(part, int(part.max()), ctx.seed + i, ctx.device,
                              t.get("level_db", -20.0)).cpu().numpy()
        for j, n in enumerate(part):
            p = np.clip(np.round(w[j, :n] * 32767.0), -32768, 32767).astype(np.int16)
            path = os.path.join(root, f"{i + j:05d}.wav")
            with open(path, "wb") as f:
                f.write(common.wav_body(p))
            pcm.append(p)
            lines.append(f"{path}\t{labels[i + j]}")
    lst = os.path.join(ctx.tmpdir, "train_list.txt")
    with open(lst, "w", encoding="utf-8") as f:
        f.write("\n".join(lines * int(t.get("repeat", 1))) + "\n")
    return lst, pcm, labels


def loader_quantized(pcm):
    """The native loader's int16 of a clip's samples: trunc(s / 32768 *
    32767) in float32."""
    return ((pcm.astype(np.float32) / np.float32(32768.0)) * np.float32(32767.0)).astype(np.int16)


def loader_mismatches(batches, pcm, labels):
    """Rows of the kept batches that are no crop of a clip of their label."""
    by_label = {}
    for i, lab in enumerate(labels):
        by_label.setdefault(int(lab), []).append(i)
    bad = 0
    for waves, labs, _ in batches:
        w, labs = waves.cpu().numpy(), labs.cpu().numpy()
        for row, lab in zip(w, labs):
            found = False
            for c in by_label.get(int(lab), []):
                q = loader_quantized(pcm[c])
                n = len(row)
                if len(q) < n:
                    continue
                cand = np.nonzero((q[:len(q) - n + 1] == row[0])
                                  & (q[1:len(q) - n + 2] == row[1]))[0]
                if any(np.array_equal(q[o:o + n], row) for o in cand):
                    found = True
                    break
            bad += not found
    return bad


def run_conf(ctx, lst):
    conf = copy.deepcopy(ctx.config["run"])
    t = ctx.traffic
    ds = conf["dataset_conf"]
    ds["train_list"] = lst
    ds["enroll_list"] = ds["trials_list"] = None
    ds["sampler"]["batch_size"] = t["batch"]
    ds["dataLoader"]["num_workers"] = t["num_workers"]
    conf["train_conf"]["enable_amp"] = bool(t.get("amp", False))
    return conf


def run(ctx):
    from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer
    t = ctx.traffic
    n_cls = ctx.config["run"]["model_conf"]["classifier"]["num_speakers"]
    marks = [time.perf_counter()]
    lst, pcm, labels = write_corpus(ctx, n_cls)
    marks.append(time.perf_counter())
    conf = run_conf(ctx, lst)
    state = common.seeded_state(ctx)
    cls_w = seeded_state({"classifier.weight": (192, n_cls)}, ctx.seed + 1,
                         ctx.device)["classifier.weight"]
    tr = Trainer(conf, device=str(ctx.device))
    tr._setup_dataloader(is_train=True)
    tr._setup_model(tr.audio_featurizer.feature_dim, is_train=True)
    tr.model.load_state_dict(state)
    tr.classifier.load_state_dict({"weight": cls_w})
    tr.model.train()
    tr.classifier.train()
    marks.append(time.perf_counter())
    log_interval = conf["train_conf"]["log_interval"]
    steps_per_epoch = len(tr.train_loader)
    named = dict(zip(tr.param_names, tr.optimizer.param_groups[0]["params"]))

    def batches():
        epoch = 0
        while True:
            epoch += 1
            tr._banks = tr.augmenter.device_banks(epoch, tr.device)
            yield from enumerate(tr.train_loader)

    feed = batches()
    losses = []

    def step():
        with ctx.spans.span("loader_wait"):
            batch_id, (kind, data, labs, lens) = next(feed)
        if tr.margin_scheduler:
            tr.margin_scheduler.step(current_step=tr.step)
        data, labs, lens = (tr._to_device(x) for x in (data, labs, lens))
        loss, _ = tr.train_step(kind, data, labs, lens)
        if batch_id % log_interval == 0:
            losses.append(float(loss))
        return data, labs, lens, loss

    n_checked = t["checked_steps"]
    before = {k: p.detach().clone() for k, p in named.items()}
    kept, kept_loss, first_m = [], [], None
    for k in range(n_checked):
        data, labs, lens, loss = step()
        kept.append((data.clone(), labs.clone(), lens.clone()))
        kept_loss.append(loss)
        if k == 0:
            first_m = {n: tr.optimizer.state.get(p, {}).get(
                "exp_avg", torch.zeros_like(p)).detach().float().clone()
                for n, p in named.items()}
    after = {k: p.detach().clone() for k, p in named.items()}
    kept_loss = [float(x) for x in kept_loss]
    for _ in range(t["warmup_steps"] - n_checked):
        step()
    common.sync(ctx.device)
    ctx.spans.times.clear()
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    setup_s = time.perf_counter() - ctx.t0
    print(f"train set-up: to the corpus {marks[0] - ctx.t0:.2f} s, corpus "
          f"{marks[1] - marks[0]:.2f} s, trainer and weights "
          f"{marks[2] - marks[1]:.2f} s, {t['warmup_steps']} steps "
          f"{time.perf_counter() - marks[2]:.2f} s", file=sys.stderr, flush=True)
    reading = {"config": ctx.config}

    def window():
        t0 = time.perf_counter()
        end, n = t0 + ctx.seconds, 0
        while time.perf_counter() < end:
            step()
            n += 1
        common.sync(ctx.device)
        return n, time.perf_counter() - t0

    if ctx.trace:
        from ..trace import traced
        with traced(ctx.spans, reading):
            steps, seconds = window()
    else:
        steps, seconds = window()
    reading.update(spans=dict(ctx.spans.times), window_s=seconds,
                   counters={"steps": steps, "batch": t["batch"],
                             "frames": traffic_frames(conf)})
    e2e = {"train_utt_per_s": core.rate(steps * t["batch"], seconds)}
    print(f"train: {steps} steps of {t['batch']} in {seconds:.3f} s, "
          f"losses {losses[-3:]}", file=sys.stderr, flush=True)

    def free():
        nonlocal tr, feed
        feed.close()
        tr = feed = None

    def check():
        b1 = 0.9
        grads_prog = {n: m / (1 - b1) for n, m in first_m.items()}
        model = reference_model(ctx.config)
        model.load_state_dict(state)
        ref_losses, ref_grads, ref_after = train_steps(
            conf, model, cls_w, kept, steps_per_epoch)
        return compare_training(ctx.config, kept_loss, grads_prog, before, after,
                                ref_losses, ref_grads, ref_after) + [
            ("loader_mismatch_rows", float(loader_mismatches(kept, pcm, labels)),
             core.limit(ctx.config, "loader_mismatch_rows"))]

    return core.Outcome(setup_s, e2e, steps, 0, reading, free, check)


def traffic_frames(conf):
    """Frames of one training crop (``max_duration`` seconds)."""
    ds = conf["dataset_conf"]["dataset"]
    n = int(ds["max_duration"] * ds["sample_rate"])
    return 1 + (n - 400) // 160


def compare_training(config, losses, grads, before, after, ref_losses,
                     ref_grads, ref_after):
    """The numbers the train cell compares, each beside its limit:
    ``loss_gap``, the worst step's |loss - ref| / |ref|; ``grad_gap``, the
    worst leaf's |norm(g) - norm(g_ref)| over the larger of norm(g_ref)
    and the median leaf's; ``update_gap``, the same of each leaf's change
    over the checked steps, among the leaves whose reference gradient is
    at least a thousandth of the median leaf's (a bias before a
    BatchNorm has a gradient of nought but rounding)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    names = sorted(ref_grads)
    gn = {n: float(ref_grads[n].double().norm()) for n in names}
    med_g = float(np.median(list(gn.values())))
    grad_gap = max(abs(float(grads[n].double().norm()) - gn[n]) / max(gn[n], med_g)
                   for n in names)
    moved = [n for n in names if gn[n] >= 1e-3 * med_g]
    dn = {n: float((ref_after[n].double() - before[n].double()).norm()) for n in moved}
    med_d = float(np.median(list(dn.values())))
    update_gap = max(abs(float((after[n].double() - before[n].double()).norm()) - dn[n])
                     / max(dn[n], med_d) for n in moved)
    return [(name, float(v), core.limit(config, name)) for name, v in (
        ("loss_gap", loss_gap), ("grad_gap", grad_gap), ("update_gap", update_gap))]
