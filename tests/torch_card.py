"""Helpers of the PyTorch port's tests that import no jax, flax or JAX
package module, so that the tests marked ``gpu`` run them on the card's
host (which has none) and the CPU tests share them: the stock configs
read by the port's YAML reader, seeded weights in the flax layout, a
float64 fbank, hard and tone inputs, the kernels' launch counters, the
eager model on exact-length clips, a seeded training corpus, one train
step held against the CPU, and a paddle state of a CAM++. No test here.
"""

import copy
import os
import wave

import numpy as np
import torch

from voiceprintrecognition_paddlepaddle_torch.utils.config import load_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0

# the configs, read by the port's YAML reader (the GPU host has no PyYAML)
CONFIG = load_yaml(os.path.join(ROOT, "configs", "cam++.yml"))
# model_conf of the six other configs/*.yml
BACKBONE_CONFS = {
    name: load_yaml(os.path.join(ROOT, "configs", f"{name}.yml"))["model_conf"]
    for name in ("tdnn", "ecapa_tdnn", "res2net", "resnet_se", "eres2net",
                 "eres2netv2")}


def random_flax_variables(model, seed):
    """Seeded random weights in the flax layout (the inverse of
    ``convert.jax_to_torch_state``), BN statistics included, so that the
    BN folding is not an identity."""
    rng = np.random.RandomState(seed)
    params, stats = {}, {}

    def put(tree, path, value):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value.astype(np.float32)

    bn_mods = {n for n, m in model.named_modules()
               if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d))}
    for key, t in model.state_dict().items():
        mod, leaf = key.rsplit(".", 1)
        path, shape = mod.split("."), tuple(t.shape)
        if mod in bn_mods:
            if leaf == "weight":
                put(params, path + ["scale"], rng.uniform(0.5, 1.5, shape))
            elif leaf == "bias":
                put(params, path + ["bias"], rng.normal(0.0, 0.2, shape))
            elif leaf == "running_mean":
                put(stats, path + ["mean"], rng.normal(0.0, 0.2, shape))
            elif leaf == "running_var":
                put(stats, path + ["var"], rng.uniform(0.5, 1.5, shape))
        elif leaf == "weight":
            fan_in = int(np.prod(shape[1:]))
            w = rng.randn(*shape) / np.sqrt(fan_in)
            order = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}[len(shape)]
            put(params, path + ["kernel"], np.transpose(w, order))
        elif leaf == "bias":
            put(params, path + ["bias"], rng.normal(0.0, 0.1, shape))
    return {"params": params, "batch_stats": stats}


def fbank_steps(fk, waves, n_mels=80, dtype=torch.float64):
    """Kaldi's fbank as a composition of library calls in ``dtype``:
    unfold, DC removal, pre-emphasis, povey window, ``torch.fft.rfft``
    (cuFFT on the card), power, mel matmul, log. In float64 it is the
    reference the fbank kernel is held to on hard inputs. The port never
    calls it."""
    tables = fk.fbank_tables(16000, n_mels, waves.device)
    x = waves.to(dtype)
    t = 1 + (x.shape[1] - 400) // 160
    frames = x[:, :(t - 1) * 160 + 400].unfold(-1, 400, 160)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = (frames - 0.97 * prev) * tables.window.to(dtype)
    spec = torch.fft.rfft(frames, n=512)[..., :256]   # Nyquist: weight 0
    power = spec.real ** 2 + spec.imag ** 2
    return torch.log(torch.clamp(power @ tables.mel.to(dtype),
                                 min=float(np.finfo(np.float32).eps)))


def khz_tone(n):
    """A 1 kHz sine of amplitude 1, ``n`` samples at 16 kHz (float64)."""
    return np.sin(2 * np.pi * 1000.0 * (np.arange(n) / 16000.0))


def tone_then_silence(n):
    """(1, n) float32: the 1 kHz tone at 0.5 for the first half, then
    digital silence."""
    return np.where(np.arange(n) < n // 2, 0.5 * khz_tone(n),
                    0.0)[None].astype(np.float32)


def hard_waves(rng):
    """{name: (B, L) float32}: inputs hard for an fp32 fbank (low energy,
    digital silence, a weak tone on a DC offset) and rows that do not
    start on 16 bytes (L % 4 != 0)."""
    waves = {"1e-4 noise": rng.randn(4, 48000) * 1e-4,
             "1 kHz tone, then 1.5 s of silence": tone_then_silence(48000),
             "1e-3 tone on a 0.5 DC offset": (0.5 + 1e-3 * khz_tone(48000))[None],
             "noise, 48123 samples": rng.randn(3, 48123) * 0.1,
             "noise, 401 samples": rng.randn(5, 401) * 0.1}
    return {k: v.astype(np.float32) for k, v in waves.items()}


def tone(f0, seconds, seed, amp=0.3, sr=16000):
    """A harmonic tone speaker with a little noise (``tests/test_predictor.py``)."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    sig = sum(np.sin(2 * np.pi * f0 * h * t + rng.rand()) / h
              for h in range(1, 5))
    return (amp * (sig + 0.05 * rng.randn(len(t)))).astype(np.float32)


def cos_min(a, b):
    """The least cosine of matching rows of ``a`` and ``b`` (arrays, or
    tensors on any device), in float64."""
    a, b = (x.detach().double().cpu().numpy() if torch.is_tensor(x)
            else np.asarray(x, np.float64) for x in (a, b))
    return float(np.min((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                            * np.linalg.norm(b, axis=-1))))


def launches():
    """The kernels' launch counters: (fbank, FCM, trunk)."""
    from voiceprintrecognition_paddlepaddle_torch.models import (fcm_kernel,
                                                                 trunk_kernel)
    from voiceprintrecognition_paddlepaddle_torch.ops import fbank_kernel

    return (fbank_kernel.fbank_fused.launches, fcm_kernel.fcm_fused.launches,
            trunk_kernel.trunk_stats.launches)


def launches_since(before):
    """Each kernel's launches since ``before`` (a ``launches()``)."""
    return [n - m for n, m in zip(launches(), before)]


def eager_embed(model, waves):
    """``model`` on exact-length (B, L) waves through ``kaldi.fbank`` and
    the masked CMN, plain PyTorch: no kernel."""
    from voiceprintrecognition_paddlepaddle_torch.ops import features, kaldi

    with torch.no_grad():
        return model(features.apply_cmn_and_mask(kaldi.fbank(waves,
                                                             n_mels=80)))


def write_wav(path, samples, sr=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2")
                      .tobytes())


def synth_corpus(root, n_train=64, clips=8, train_s=(3.0, 5.0), n_eval=8,
                 enroll=2, trials=3, eval_s=(3.0, 20.0), seed=SEED):
    """Seeded WAVs under ``root``: speaker k a harmonic stack on its own
    f0 with noise (``tests/test_trainer_e2e.py``), ``n_train`` train
    speakers of ``clips`` clips and ``n_eval`` other speakers with
    ``enroll`` enroll and ``trials`` trial clips. Returns the train, enroll
    and trials list paths."""
    rng = np.random.RandomState(seed)
    wavs = os.path.join(root, "wavs")
    os.makedirs(wavs, exist_ok=True)

    def clip(f0, seconds, name):
        t = np.arange(int(seconds * 16000)) / 16000
        sig = sum(np.sin(2 * np.pi * f0 * h * t + rng.rand()) / h
                  for h in range(1, 5))
        path = os.path.join(wavs, name)
        write_wav(path, rng.uniform(0.1, 0.4) * (sig + 0.1 * rng.randn(len(t))))
        return path

    lists = {"train": [], "enroll": [], "trials": []}
    for k in range(n_train):
        f0 = 90.0 + 5.0 * k
        lists["train"] += [f"{clip(f0, rng.uniform(*train_s), f't{k}_{i}.wav')}"
                           f"\t{k}" for i in range(clips)]
    for k in range(n_eval):
        f0 = 92.5 + 37.0 * k
        for part, n in (("enroll", enroll), ("trials", trials)):
            lists[part] += [f"{clip(f0, rng.uniform(*eval_s), f'{part}{k}_{i}.wav')}"
                            f"\t{k}" for i in range(n)]
    out = []
    for part in ("train", "enroll", "trials"):
        path = os.path.join(root, f"{part}_list.txt")
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(lists[part]) + "\n")
        out.append(path)
    return out


def train_config(lists, **changes):
    """``CONFIG`` with the list paths set (and ``changes``, dotted keys);
    returns the config and every change made."""
    cfg = copy.deepcopy(CONFIG)
    done = dict(zip(("dataset_conf.train_list", "dataset_conf.enroll_list",
                     "dataset_conf.trials_list"), lists), **changes)
    for key, value in done.items():
        node = cfg
        *path, leaf = key.split(".")
        for k in path:
            node = node[k]
        node[leaf] = value
    return cfg, done


def _one_step(tr, variables, classifier, batch, step):
    """``tr``'s train step from the given weights on ``batch`` at the
    trainer's step ``step``: the loss, the gradients (caught before the
    update), the parameters after it and the BN statistics, on the CPU
    in float64."""
    from voiceprintrecognition_paddlepaddle_torch.models.convert import \
        jax_to_torch_state

    tr.model.load_state_dict(jax_to_torch_state(variables))
    tr.classifier.load_state_dict(classifier)
    tr.step = step
    grads = {}

    def catch(opt, args, kwargs):
        for n, p in zip(tr.param_names, opt.param_groups[0]["params"]):
            grads[n] = p.grad.detach().double().cpu()

    hook = tr.optimizer.register_step_pre_hook(catch)
    kind, data, labels, lens = batch
    tr.model.train()
    tr.classifier.train()
    loss, _ = tr.train_step(kind, *(torch.from_numpy(x).to(tr.device)
                                    for x in (data, labels, lens)))
    hook.remove()
    return {"loss": float(loss), "grads": grads,
            "params": {n: p.detach().double().cpu() for n, p in
                       zip(tr.param_names,
                           tr.optimizer.param_groups[0]["params"])},
            "stats": {k: v.double().cpu() for k, v in
                      tr.model.state_dict().items() if "running" in k}}


def _step_diff(c, g):
    """The card's step ``g`` against the CPU's ``c``."""
    top = max(float(v.norm()) for v in c["grads"].values())
    cos, small = {}, {}
    for n, v in c["grads"].items():
        w = g["grads"][n]
        if float(v.norm()) >= 1e-5 * top:
            cos[n] = float((v * w).sum() / (v.norm() * w.norm()))
        else:   # zero up to rounding: a bias ahead of a BatchNorm
            small[n] = float((v - w).norm()) / top
    flat_c = torch.cat([v.flatten() for v in c["grads"].values()])
    flat_g = torch.cat([g["grads"][n].flatten() for n in c["grads"]])
    stats = max(float((g["stats"][k] - v).abs().max() / v.abs().max())
                for k, v in c["stats"].items())
    # Adam's first step moves an entry by lr * g / (|g| + 1e-8), about
    # lr * sign(g): compare the entries whose gradient sets that sign on
    # both sides (above 1e-3 of the leaf's largest and 1e-6 on both), in
    # the leaves whose gradient is not rounding alone
    held, flips, total, par, worst = 0, 0, 0, 0.0, None
    for n, v in c["params"].items():
        total += v.numel()
        if n not in cos:
            continue
        gc, gg = c["grads"][n], g["grads"][n]
        det = (gc.abs() > 1e-3 * gc.abs().max()) & (gc.abs() > 1e-6)
        same = det & (torch.sign(gc) == torch.sign(gg)) & (gg.abs() > 1e-6)
        d = torch.where(same, (g["params"][n] - v).abs(), 0.0)
        rel = float(d.max()) / float(v.abs().max())
        if rel > par:
            i = int(d.flatten().argmax())
            par, worst = rel, (n, float(gc.flatten()[i]),
                               float(gg.flatten()[i]), float(v.flatten()[i]),
                               float(g["params"][n].flatten()[i]))
        held += int(same.sum())
        flips += int((det & ~same).sum())
    return {"loss_card": g["loss"],
            "loss_rel": abs(g["loss"] - c["loss"]) / abs(c["loss"]),
            "grad_cos_all": float((flat_c * flat_g).sum()
                                  / (flat_c.norm() * flat_g.norm())),
            "grad_cos_min": min(cos.values()),
            "grad_cos_worst": sorted(
                (round(v, 6), n, float(c["grads"][n].norm()) / top)
                for n, v in cos.items())[:4],
            "grad_leaves": len(cos), "rounding_leaves": len(small),
            "rounding_leaf_max_d": max(small.values(), default=0.0),
            "bn_stats_rel": stats, "param_rel": par,
            "param_worst": worst,
            "param_entries_held": held, "param_sign_flips": flips,
            "param_entries": total}


def held_step(cfg, dev, seed=SEED, step=None):
    """One train step of ``cfg`` on ``dev`` against the same step on the
    CPU: the same weights (seeded through models/convert.py), the same
    first batch of the train list, no augmentation (the dB normalization
    runs). The card runs it twice: with cuDNN's TF32 convs (PyTorch's
    default, what training uses) and in fp32. ``step``: the trainer's
    step count before it (the schedule's update), by default the end of
    the warmup, where the LR is at its peak. Returns the measured
    differences of each."""
    from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer

    cpu = Trainer(cfg, device="cpu")
    cpu._setup_dataloader(is_train=True)
    cpu._setup_model(cpu.audio_featurizer.feature_dim, is_train=True)
    variables = random_flax_variables(cpu.model, seed)
    classifier = {k: v.clone() for k, v in cpu.classifier.state_dict().items()}
    if step is None:
        warm = cfg["optimizer_conf"]["scheduler_args"].get("warmup_epoch", 5)
        step = int(warm * len(cpu.train_loader))
    cpu.train_dataset._rng.seed(seed)        # the crops of the batch
    batch = next(iter(cpu.train_loader))
    ref = _one_step(cpu, variables, classifier, batch, step)
    out = {"loss_cpu": ref["loss"], "step": step, "lr": cpu.lr_schedule(step)}
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        for name, allow in (("tf32", True), ("fp32", False)):
            torch.backends.cudnn.allow_tf32 = allow
            card = Trainer(cfg, device=dev)
            card._setup_dataloader(is_train=True)
            card._setup_model(card.audio_featurizer.feature_dim, is_train=True)
            out[name] = _step_diff(
                ref, _one_step(card, variables, classifier, batch, step))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return out


def held_step_ok(held, per_leaf=True):
    """The gates, from what the card measured (two batches each). fp32
    convs: the loss and the BN statistics within 1e-3 relative, the whole
    gradient cos >= 0.999 (measured 0.99970, 0.99972), every leaf
    cos >= 0.995 (measured down to 0.99869, 0.99930: small CAM-gate
    leaves, 1e-4 of the largest leaf's norm, from summation order alone),
    the leaves that are zero up to rounding within 1e-3 of the largest
    leaf's norm, the updated parameters within 1e-3 of each leaf's scale
    where both gradients set the same Adam sign (measured 6.0e-5, on 89.8 %
    of the entries; the gate asks 75 % or more). TF32 convs (PyTorch's default, what training uses; measured
    loss 5.9e-4 and 1.6e-3 relative off the CPU's fp32, whole-gradient cos
    0.966 and 0.969, leaves down to 0.785): the loss within 1e-2, the
    whole gradient cos >= 0.9, the BN statistics within 1e-3.
    ``per_leaf=False`` drops the leaf bar (the tiny model of
    ``tests/test_torch_gpu.py``, whose 1e-5 cutoff does not separate its
    zero-up-to-rounding leaves)."""
    f, t = held["fp32"], held["tf32"]
    return (f["loss_rel"] <= 1e-3 and f["grad_cos_all"] >= 0.999
            and (f["grad_cos_min"] >= 0.995 or not per_leaf)
            and f["rounding_leaf_max_d"] <= 1e-3 and f["bn_stats_rel"] <= 1e-3
            and f["param_rel"] <= 1e-3
            and f["param_entries_held"] >= 0.75 * f["param_entries"]
            and t["loss_rel"] <= 1e-2 and t["grad_cos_all"] >= 0.9
            and t["bn_stats_rel"] <= 1e-3)


def paddle_shape(kind, f):
    """The paddle shape of a converter spec entry of ``kind`` whose flax
    leaf has the shape ``f``."""
    return {"conv1d_w": lambda: (f[2], f[1], f[0]),
            "conv2d_w": lambda: (f[3], f[2], f[0], f[1]),
            "conv1d_as_dense_w": lambda: (f[1], f[0], 1)}.get(
        kind, lambda: tuple(f))()


def synth_pdparams(model, model_args, seed):
    """A reference paddle ``state_dict`` (numpy, ``0.``-prefixed keys) for
    the CAM++ ``model`` (``CAMPPlus(80, **model_args)``): every key of the
    converter's spec, in paddle's layouts, drawn as
    ``random_flax_variables`` draws its leaves."""
    from voiceprintrecognition_paddlepaddle_torch.models.convert_paddle \
        import SPECS

    flax_tree = random_flax_variables(model, seed)     # for the shapes
    rng = np.random.RandomState(seed + 11)
    out = {}
    for pkey, coll, fpath, _, kind in SPECS["CAMPPlus"](80, **model_args):
        node = flax_tree[coll]
        for k in fpath.split("/"):
            node = node[k]
        shape = paddle_shape(kind, node.shape)
        if kind.endswith("_w"):
            fan_in = shape[0] if kind == "dense_w" else np.prod(shape[1:])
            x = rng.randn(*shape) / np.sqrt(fan_in)
        elif pkey.endswith("._variance") or fpath.endswith("/scale"):
            x = rng.uniform(0.5, 1.5, shape)
        elif pkey.endswith("._mean"):
            x = rng.normal(0.0, 0.2, shape)
        else:
            x = rng.normal(0.0, 0.1, shape)
        out[f"0.{pkey}"] = x.astype(np.float32)
    return out


def pdparams_of(model, model_args):
    """A paddle ``state_dict`` (numpy, ``0.``-prefixed keys) holding the
    CAM++ ``model``'s own weights: the model's state in the flax layout
    (the inverse of ``convert.jax_to_torch_state``), then the inverse of
    each transform of the converter's spec (each a permutation)."""
    from voiceprintrecognition_paddlepaddle_torch.models.convert_paddle \
        import SPECS

    bn_mods = {n for n, m in model.named_modules()
               if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d))}
    tree = {"params": {}, "batch_stats": {}}
    for key, t in model.state_dict().items():
        mod, leaf = key.rsplit(".", 1)
        v = t.detach().cpu().numpy()
        if leaf == "num_batches_tracked":
            continue
        coll = "params"
        if mod in bn_mods:
            coll, leaf = {"weight": ("params", "scale"),
                          "bias": ("params", "bias"),
                          "running_mean": ("batch_stats", "mean"),
                          "running_var": ("batch_stats", "var")}[leaf]
        elif leaf == "weight":
            leaf = "kernel"
            v = np.transpose(v, {2: (1, 0), 3: (2, 1, 0),
                                 4: (2, 3, 1, 0)}[v.ndim])
        elif leaf != "bias":
            raise KeyError(f"no flax leaf for {key}")
        node = tree[coll]
        for k in mod.split("."):
            node = node.setdefault(k, {})
        node[leaf] = v
    out = {}
    for pkey, coll, fpath, tf, kind in SPECS["CAMPPlus"](80, **model_args):
        v = tree[coll]
        for k in fpath.split("/"):
            v = v[k]
        # every transform moves elements only: carry the paddle indices
        # through it and scatter the flax values back
        shape = paddle_shape(kind, v.shape)
        idx = np.asarray(tf(np.arange(int(np.prod(shape))).reshape(shape)))
        w = np.empty(idx.size, np.float32)
        w[idx.ravel()] = v.ravel()
        out[f"0.{pkey}"] = w.reshape(shape)
    return out
