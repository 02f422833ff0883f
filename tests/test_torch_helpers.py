"""Shared fixtures-in-functions for the PyTorch port's parity tests.

One synthetic paddle-layout state dict (``_synth_paddle_state``, with
non-trivial BN statistics) goes to flax through ``convert_state`` and to
the port through ``jax_to_torch_state``, so both sides hold the same
weights. Inputs are numpy arrays made from seeds and handed to both.
"""

import numpy as np

from test_convert_paddle import _model_tree_shapes, _synth_paddle_state
from tools.convert_paddle_checkpoint import SPECS, convert_state

FULL = dict(embd_dim=192)                                  # configs/cam++.yml
SMALL = dict(embd_dim=32, init_channels=32)


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


def tone(f0, seconds, seed, amp=0.3, sr=16000):
    """A harmonic tone speaker with a little noise (``tests/test_predictor.py``)."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    sig = sum(np.sin(2 * np.pi * f0 * h * t + rng.rand()) / h
              for h in range(1, 5))
    return (amp * (sig + 0.05 * rng.randn(len(t)))).astype(np.float32)


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


def cos_min(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.min((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                            * np.linalg.norm(b, axis=-1))))


def rel_err(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-9))
