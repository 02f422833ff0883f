"""PyTorch port, the ``.pdparams`` converter (``models/convert_paddle.py``
and ``python -m voiceprintrecognition_paddlepaddle_torch.convert_paddle``)
against the JAX package's ``tools/convert_paddle_checkpoint.py``.

For every model config in ``configs/`` at its full width, the same
synthetic paddle state (``_synth_paddle_state``: every key of the spec,
non-trivial BN statistics) gives equal flax trees through both
converters, bit for bit, and ``pdparams_to_torch_state`` equals
``jax_to_torch_state`` of the JAX tree; a classifier converts the same
way; an unconsumed key is rejected. The command line writes ``model.pt``
from a pickled ``.pdparams`` of a tiny CAM++, with PyYAML unimportable,
and ``Predictor(device="cpu")`` on it embeds like the JAX ``Predictor``
on the JAX converter's tree (cos >= 0.9999, the port's Predictor bar)."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml
from flax import serialization

import torch_jax_native  # noqa: F401 (JAX's native library, locked)
from test_convert_paddle import (CONFIGS, SMALL, _load_cfg,
                                 _model_tree_shapes, _synth_paddle_state)
from torch_card import cos_min
from tools import convert_paddle_checkpoint as jconv
from voiceprintrecognition_paddlepaddle_torch.models import \
    convert_paddle as tconv
from voiceprintrecognition_paddlepaddle_torch.models.convert import \
    jax_to_torch_state
from voiceprintrecognition_paddlepaddle_torch.predict import Predictor
from voiceprintrecognition_paddlepaddle_tpu.predict import \
    Predictor as JaxPredictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _equal_trees(a, b, path=""):
    assert isinstance(b, dict) and a.keys() == b.keys(), path
    for k in a:
        if isinstance(a[k], dict):
            _equal_trees(a[k], b[k], f"{path}/{k}")
        else:
            assert a[k].dtype == b[k].dtype, f"{path}/{k}"
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{path}/{k}")


def test_specs_are_the_jax_converters():
    assert sorted(tconv.SPECS) == sorted(jconv.SPECS)


@pytest.mark.parametrize("fname", CONFIGS)
def test_trees_equal_the_jax_converters(fname):
    name, args, n_mels = _load_cfg(fname)
    param_shapes, stat_shapes = _model_tree_shapes(name, args, n_mels)
    entries = jconv.SPECS[name](n_mels, **args)
    assert [e[:3] + (e[4],) for e in tconv.SPECS[name](n_mels, **args)] == \
        [e[:3] + (e[4],) for e in entries]
    state = _synth_paddle_state(entries, param_shapes, stat_shapes,
                                np.random.RandomState(0))
    want = jconv.convert_state(state, name, n_mels, model_args=args)
    got = tconv.convert_state(state, name, n_mels, model_args=args)
    _equal_trees(want, got)
    sd = tconv.pdparams_to_torch_state(state, name, n_mels,
                                       model_args=args)["model"]
    ref = jax_to_torch_state({"params": want["params"]["backbone"],
                              "batch_stats": want["batch_stats"]["backbone"]})
    assert list(sd) == list(ref)
    assert all(torch.equal(sd[k], ref[k]) for k in ref)


def test_classifier_and_unconsumed_keys():
    bargs = SMALL["TDNN"]
    bp, bs = _model_tree_shapes("TDNN", bargs, 40)
    rng = np.random.RandomState(2)
    state = {"0." + k: v for k, v in _synth_paddle_state(
        jconv.SPECS["TDNN"](40, **bargs), bp, bs, rng).items()}
    state["1.weight"] = rng.randn(16, 10).astype(np.float32)
    conf = dict(input_dim=16, num_speakers=10)
    want = jconv.convert_state(state, "TDNN", 40, model_args=bargs,
                               classifier_conf=conf)
    got = tconv.convert_state(state, "TDNN", 40, model_args=bargs,
                              classifier_conf=conf)
    _equal_trees(want, got)
    out = tconv.pdparams_to_torch_state(state, "TDNN", 40, model_args=bargs,
                                        classifier_conf=conf)
    assert torch.equal(out["classifier"]["weight"],
                       torch.from_numpy(state["1.weight"]))
    state["0.nonexistent.weight"] = np.zeros((3, 3), np.float32)
    with pytest.raises(KeyError, match="unconsumed"):
        tconv.convert_state(state, "TDNN", 40, model_args=bargs,
                            classifier_conf=conf)


def test_command_line_model_embeds_like_jax(tmp_path):
    with open(os.path.join(ROOT, "configs", "cam++.yml"),
              encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    args = {"embd_dim": 32, "init_channels": 32}
    cfg["model_conf"]["model_args"] = args
    cfg_path = tmp_path / "tiny.yml"
    cfg_path.write_text(yaml.safe_dump(cfg), encoding="utf-8")
    param_shapes, stat_shapes = _model_tree_shapes("CAMPPlus", args, 80)
    state = _synth_paddle_state(jconv.SPECS["CAMPPlus"](80, **args),
                                param_shapes, stat_shapes,
                                np.random.RandomState(6))
    pdparams = tmp_path / "model.pdparams"
    with open(pdparams, "wb") as f:
        pickle.dump({f"0.{k}": v for k, v in state.items()}, f)
    out = tmp_path / "converted"
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["OMP_NUM_THREADS"] = "2"
    code = ("import sys; sys.modules['yaml'] = None\n"
            "from voiceprintrecognition_paddlepaddle_torch.convert_paddle "
            "import main\n"
            f"main(['--configs={cfg_path}', '--pdparams={pdparams}', "
            f"'--output={out}'])\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "converted" in run.stdout and (out / "model.pt").exists()

    tree = jconv.convert_state(state, "CAMPPlus", 80, model_args=args)
    msgpack = tmp_path / "model.msgpack"
    msgpack.write_bytes(serialization.msgpack_serialize(
        {"params": tree["params"]["backbone"],
         "batch_stats": tree["batch_stats"]["backbone"]}))
    pred = Predictor(str(cfg_path), model_path=str(out), device="cpu")
    jpred = JaxPredictor(cfg, model_path=str(msgpack), use_gpu=False)
    rng = np.random.RandomState(8)
    clips = [(rng.randn(n) * 0.05).astype(np.float32)
             for n in (16000, 27000, 9000)]
    got, want = pred.predict_batch(clips), jpred.predict_batch(clips)
    assert got.shape == want.shape == (3, 32)
    assert cos_min(want, got) > 0.9999
