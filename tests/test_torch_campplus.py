"""PyTorch port, CAM++ model: the eager ``CAMPPlus`` (fp32) against the JAX
``CAMPPlus.apply`` with the same synthetic paddle weights, at a narrow
width and at the full ``configs/cam++.yml`` width, exact-length and with
``lengths``; and the pieces the serving path reuses (FCM layout, the
DenseBN head, ``masked_mean_var``, the weight converter).

Bar (``tests/test_torch_crosscheck.py:470-471``): cos > 0.9999 and
max |d| / scale < 5e-3 on the embeddings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import FULL, SMALL, rel_err, synth_campplus
from torch_card import cos_min
from voiceprintrecognition_paddlepaddle_torch.models import build_model
from voiceprintrecognition_paddlepaddle_torch.models.convert import \
    jax_to_torch_state
from voiceprintrecognition_paddlepaddle_torch.models.pooling import \
    masked_mean_var
from voiceprintrecognition_paddlepaddle_torch.utils.utils import \
    dict_to_object
from voiceprintrecognition_paddlepaddle_tpu.models import pooling as jpool
from voiceprintrecognition_paddlepaddle_tpu.models.campplus import FCM

_MODELS = {}


def _model(width):
    if width not in _MODELS:
        jm, v, tm = synth_campplus(FULL if width == "full" else SMALL,
                                   seed=1)
        _MODELS[width] = (jm, v, tm, jax.jit(
            lambda v_, x, l: jm.apply(v_, x, train=False, lengths=l)))
    return _MODELS[width]


@pytest.fixture(scope="module", params=["small", "full"])
def models(request):
    return _model(request.param)


def _assert_embed_bar(ref, got):
    assert got.shape == ref.shape
    assert cos_min(ref, got) > 0.9999
    assert rel_err(ref, got) < 5e-3


def test_eager_matches_jax_exact_length(models):
    jm, v, tm, japply = models
    x = np.random.RandomState(0).randn(2, 250, 80).astype(np.float32)
    ref = np.asarray(japply(v, jnp.asarray(x), None))
    _assert_embed_bar(ref, tm(torch.from_numpy(x)).numpy())


def test_eager_matches_jax_with_lengths(models):
    jm, v, tm, japply = models
    x = np.random.RandomState(1).randn(3, 250, 80).astype(np.float32)
    lengths = np.asarray([1.0, 0.6, 0.33], np.float32)
    ref = np.asarray(japply(v, jnp.asarray(x), jnp.asarray(lengths)))
    got = tm(torch.from_numpy(x), lengths=torch.from_numpy(lengths)).numpy()
    _assert_embed_bar(ref, got)


def test_fcm_output_is_frequency_major():
    _, v, tm, _ = _model("full")
    x = np.random.RandomState(2).randn(2, 98, 80).astype(np.float32)
    ref = np.asarray(FCM().apply({"params": v["params"]["FCM_0"],
                                  "batch_stats": v["batch_stats"]["FCM_0"]},
                                 jnp.asarray(x), train=False))
    got = tm.FCM_0(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 98, 320)
    assert rel_err(ref, got) < 1e-4


def test_converted_state_loads_strictly_and_covers_every_tensor():
    _, v, tm, _ = _model("full")
    state = jax_to_torch_state(v)
    assert set(state) == set(tm.state_dict())
    for k, t in tm.state_dict().items():
        assert tuple(state[k].shape) == tuple(t.shape), k


@pytest.mark.parametrize("ddof", [0, 1])
def test_masked_mean_var_matches_jax(ddof):
    x = np.random.RandomState(3).randn(3, 37, 5).astype(np.float32)
    lengths = np.asarray([1.0, 0.5, 0.05], np.float32)
    for lens in (None, lengths):
        jm, jv = jpool.masked_mean_var(jnp.asarray(x), lens, ddof=ddof)
        tm, tv = masked_mean_var(torch.from_numpy(x), lens, ddof=ddof)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


def test_build_model_serves_campplus_only():
    """``build_model`` raised for every backbone but CAM++ while the port
    had CAM++ only. It now builds the backbone each config in
    ``configs/`` names, with the JAX package's arguments (YAML lists as
    tuples), and raises ``ValueError`` for an unknown name, as JAX does.
    Its backbones are the JAX package's and the port's own, which the
    JAX package lacks: MFA-Conformer, whose config sits in the port's
    ``configs/`` (``mfa_conformer.yml``)."""
    import glob
    import os

    import yaml

    from voiceprintrecognition_paddlepaddle_torch.models import MODELS
    from voiceprintrecognition_paddlepaddle_tpu.models import \
        MODELS as JAX_MODELS

    port_only = {"MFAConformer"}
    assert not port_only & set(JAX_MODELS)
    assert set(MODELS) == set(JAX_MODELS) | port_only
    cfg = dict_to_object({"model_conf": {"model": "CAMPPlus",
                                         "model_args": {"embd_dim": 192}}})
    m = build_model(80, cfg)
    assert m.embd_dim == 192 and m.init_channels == 128
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    built = set()
    port = os.path.join(root, "voiceprintrecognition_paddlepaddle_torch")
    for path in (glob.glob(os.path.join(root, "configs", "*.yml"))
                 + glob.glob(os.path.join(port, "configs", "*.yml"))):
        with open(path, encoding="utf-8") as f:
            conf = yaml.safe_load(f)
        if "model_conf" not in conf:
            continue
        model = build_model(80, dict_to_object(conf))
        assert type(model).__name__ == conf["model_conf"]["model"], path
        built.add(conf["model_conf"]["model"])
    assert built == set(MODELS)
    cfg.model_conf.model = "EcapaTdnn"
    assert type(build_model(80, cfg)).__name__ == "EcapaTdnn"
    cfg.model_conf.model = "WavLM"
    with pytest.raises(ValueError, match="unknown model"):
        build_model(80, cfg)
