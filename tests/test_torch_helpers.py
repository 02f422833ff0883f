"""Shared fixtures-in-functions for the PyTorch port's parity tests.

One synthetic paddle-layout state dict (``_synth_paddle_state``, with
non-trivial BN statistics) goes to flax through ``convert_state`` and to
the port through ``jax_to_torch_state``, so both sides hold the same
weights. The other backbones take seeded values in the parameter tree of
their flax ``init``, BN statistics included (``synth_flax``). Inputs are
numpy arrays made from seeds and handed to both.
"""

import numpy as np

from test_convert_paddle import _model_tree_shapes, _synth_paddle_state
from torch_card import tone, write_wav
from tools.convert_paddle_checkpoint import SPECS, convert_state

FULL = dict(embd_dim=192)                                  # configs/cam++.yml
SMALL = dict(embd_dim=32, init_channels=32)

# the six other backbones at narrow widths (a few blocks, 8-96 channels)
NARROW = {
    "TDNN": dict(channels=32, embd_dim=16),
    "EcapaTdnn": dict(channels=(32, 32, 32, 32, 96), embd_dim=16,
                      attention_channels=16, res2net_scale=4,
                      se_channels=16),
    "ResNetSE": dict(layers=(1, 2, 1, 1), num_filters=(8, 16, 16, 32),
                     embd_dim=16),
    "Res2Net": dict(m_channels=8, layers=(1, 2, 1, 1), embd_dim=16),
    "ERes2Net": dict(num_blocks=(1, 1, 2, 1), m_channels=8, embd_dim=16,
                     two_emb_layer=True),
    "ERes2NetV2": dict(num_blocks=(1, 2, 1, 1), m_channels=8, embd_dim=16),
}


def seeded_variables(tree, rng):
    """Seeded values for a flax tree of shapes (``jax.eval_shape`` of
    ``init``): kernels scaled by fan-in, BN scales / statistics and
    biases drawn away from their 1 / 0 starts, PReLU slopes, the Cosine
    head's weight."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = seeded_variables(v, rng)
            continue
        shape = tuple(v.shape)
        if k == "kernel":
            x = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif k in ("scale", "var"):
            x = rng.uniform(0.5, 1.5, shape)
        elif k in ("bias", "mean"):
            x = rng.normal(0.0, 0.2, shape)
        elif k == "prelu_alpha":
            x = rng.uniform(0.1, 0.4, shape)
        elif k == "weight":
            x = rng.randn(*shape)
        else:
            raise KeyError(k)
        out[k] = x.astype(np.float32)
    return out


def synth_flax(jmodel, tmodel, x, seed=0):
    """Seeded weights in the parameter tree of ``jmodel.init`` on ``x``
    (``seeded_variables``), loaded strictly into the port's ``tmodel``
    (fp32, eval). Returns the numpy variables."""
    import flax
    import jax

    from voiceprintrecognition_paddlepaddle_torch.models.convert import \
        jax_to_torch_state

    shapes = flax.core.unfreeze(jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(seed), x))
    v = seeded_variables(shapes, np.random.RandomState(seed))
    v.setdefault("params", {})
    v.setdefault("batch_stats", {})
    tmodel.load_state_dict(jax_to_torch_state(v), strict=True)
    tmodel.eval().requires_grad_(False)
    return v


def synth_backbone(name, args, input_size=24, seed=0):
    """-> (flax model, flax variables (numpy), port model in fp32 eval)."""
    from voiceprintrecognition_paddlepaddle_torch.models import \
        MODELS as TORCH_MODELS
    from voiceprintrecognition_paddlepaddle_tpu.models import MODELS

    jm = MODELS[name](input_size=input_size, **args)
    tm = TORCH_MODELS[name](input_size, **args)
    v = synth_flax(jm, tm, np.zeros((1, 64, input_size), np.float32), seed)
    return jm, v, tm


def synth_campplus(args, input_size=80, seed=0):
    """-> (flax CAMPPlus, flax variables (numpy), port CAMPPlus in fp32 eval)."""
    from voiceprintrecognition_paddlepaddle_torch.models.campplus import \
        CAMPPlus as TorchCAMPPlus
    from voiceprintrecognition_paddlepaddle_torch.models.convert import \
        jax_to_torch_state
    from voiceprintrecognition_paddlepaddle_tpu.models import CAMPPlus

    param_shapes, stat_shapes = _model_tree_shapes("CAMPPlus", args,
                                                    input_size)
    entries = SPECS["CAMPPlus"](input_size, **args)
    state = _synth_paddle_state(entries, param_shapes, stat_shapes,
                                np.random.RandomState(seed))
    tree = convert_state(state, "CAMPPlus", input_size, model_args=args)
    variables = {"params": tree["params"]["backbone"],
                 "batch_stats": tree["batch_stats"]["backbone"]}
    tmodel = TorchCAMPPlus(input_size, **args)
    tmodel.load_state_dict(jax_to_torch_state(variables))
    tmodel.eval().requires_grad_(False)
    return CAMPPlus(input_size=input_size, **args), variables, tmodel


def calibrate_bn_stats(variables, tmodel, waves):
    """Re-estimate every BN's statistics of the port model on ``waves``
    (one train-mode pass with cumulative averages) and write them into both
    the flax ``variables`` and ``tmodel``. Random weights then give
    embeddings that tell tone and noise speakers apart, as trained ones do;
    before, every clip embeds at cos ~1 to every other."""
    import torch

    from voiceprintrecognition_paddlepaddle_torch.models.convert import \
        jax_to_torch_state
    from voiceprintrecognition_paddlepaddle_torch.ops.features import \
        AudioFeaturizer

    feats = AudioFeaturizer("Fbank", {"sr": 16000, "n_mels": 80})(
        torch.from_numpy(np.stack(waves)))
    bns = {n: m for n, m in tmodel.named_modules()
           if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d))}
    for m in bns.values():
        m.reset_running_stats()
        m.momentum = None
    tmodel.train()
    with torch.no_grad():
        tmodel(feats)
    for name, m in bns.items():
        node = variables["batch_stats"]
        for k in name.split("."):
            node = node[k]
        node["mean"] = m.running_mean.numpy().astype(np.float32)
        node["var"] = m.running_var.numpy().astype(np.float32)
    tmodel.load_state_dict(jax_to_torch_state(variables))
    tmodel.eval()
    return variables, tmodel


def calibration_clips():
    """Six tone speakers and four noise levels, 1.5 s each."""
    rng = np.random.RandomState(0)
    clips = [tone(f, 1.5, i) for i, f in enumerate((120, 150, 200, 260,
                                                   330, 400))]
    return clips + [(rng.randn(24000) * s).astype(np.float32)
                    for s in (0.05, 0.1, 0.2, 0.3)]


def rel_err(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-9))


def speaker_corpus(root, n_speakers=4, n_utts=6, seconds=(1.2, 1.2), seed=0):
    """Seeded WAVs under ``root / "wavs"``: speaker ``s`` a harmonic stack
    on f0 = 120 + 90 s Hz with noise (as ``tests/test_trainer_e2e.py``),
    utterance lengths drawn from ``seconds``. Writes ``train_list.txt``,
    ``enroll.txt`` (the first half of each speaker's utterances) and
    ``trials.txt`` (the rest) and returns the three paths."""
    import os

    rng = np.random.RandomState(seed)
    os.makedirs(root / "wavs", exist_ok=True)
    lines = []
    for spk in range(n_speakers):
        f0 = 120 + 90 * spk
        for u in range(n_utts):
            t = np.arange(int(rng.uniform(*seconds) * 16000)) / 16000
            sig = sum(np.sin(2 * np.pi * f0 * h * t + rng.rand()) / h
                      for h in range(1, 5))
            sig = 0.3 * (sig + 0.05 * rng.randn(len(t)))
            p = root / "wavs" / f"s{spk}_u{u}.wav"
            write_wav(p, sig)
            lines.append((u, f"{p}\t{spk}"))
    paths = [root / n for n in ("train_list.txt", "enroll.txt", "trials.txt")]
    half = n_utts // 2
    for path, keep in zip(paths, (lambda u: True, lambda u: u < half,
                                  lambda u: u >= half)):
        path.write_text("\n".join(ln for u, ln in lines if keep(u)) + "\n",
                        encoding="utf-8")
    return [str(p) for p in paths]


def train_configs(lists, model="TDNN", model_args=None, max_epoch=2,
                  batch_size=8, n_mels=40, num_speakers=4, loss="AAMLoss",
                  loss_args=None, optimizer="Adam", **train_conf):
    """A small training config over ``speaker_corpus`` lists."""
    train_list, enroll, trials = lists
    return {
        "dataset_conf": {
            "dataset": {"min_duration": 0.3, "max_duration": 1.0,
                        "sample_rate": 16000, "use_dB_normalization": True,
                        "target_dB": -20},
            "sampler": {"batch_size": batch_size, "shuffle": True,
                        "drop_last": True},
            "dataLoader": {"num_workers": 2},
            "eval_conf": {"batch_size": 4, "max_duration": 2},
            "train_list": train_list, "enroll_list": enroll,
            "trials_list": trials,
        },
        "preprocess_conf": {"feature_method": "Fbank",
                            "method_args": {"sr": 16000, "n_mels": n_mels}},
        "model_conf": {
            "model": model,
            "model_args": model_args or {"embd_dim": 32, "channels": 32,
                                         "pooling_type": "TSP"},
            "classifier": {"classifier_type": "Cosine",
                           "num_speakers": num_speakers, "num_blocks": 0},
        },
        "loss_conf": {"loss": loss,
                      "loss_args": loss_args or {"margin": 0.2, "scale": 32},
                      "use_margin_scheduler": True,
                      "margin_scheduler_args": {"initial_margin": 0.0,
                                                "final_margin": 0.3}},
        "optimizer_conf": {"optimizer": optimizer,
                           "optimizer_args": {"weight_decay": 1.0e-6},
                           "scheduler": "WarmupCosineSchedulerLR",
                           "scheduler_args": {"learning_rate": 0.01,
                                              "min_lr": 1.0e-5,
                                              "warmup_epoch": 1}},
        "train_conf": {"enable_amp": False, "max_epoch": max_epoch,
                       "log_interval": 1, **train_conf},
    }
