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


def cos_min(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.min((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                            * np.linalg.norm(b, axis=-1))))


def rel_err(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    return float(np.abs(ref - got).max() / (np.abs(ref).max() + 1e-9))
