"""PyTorch port, the six other backbones (TDNN, ECAPA-TDNN, ResNetSE,
Res2Net, ERes2Net, ERes2NetV2), their poolings and heads, against the JAX
modules' ``apply`` with the same seeded weights in the parameter tree of the
flax ``init``, BN statistics included, loaded into the port through
``jax_to_torch_state`` with ``strict=True``. Narrow widths, a few blocks;
exact-length and with ``lengths``.

Bar (as ``tests/test_torch_campplus.py``): cos > 0.9999 and
max |d| / scale < 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import NARROW, rel_err, synth_backbone, synth_flax
from torch_card import cos_min
from voiceprintrecognition_paddlepaddle_torch.models import layers as tlayers
from voiceprintrecognition_paddlepaddle_torch.models import pooling as tpool
from voiceprintrecognition_paddlepaddle_torch.models.campplus import \
    CAMDenseTDNNBlock as TorchCAMDenseTDNNBlock
from voiceprintrecognition_paddlepaddle_torch.models.campplus import \
    TDNNLayer as TorchTDNNLayer
from voiceprintrecognition_paddlepaddle_torch.models.convert import \
    jax_to_torch_state
from voiceprintrecognition_paddlepaddle_torch.models.fc import \
    SpeakerIdentification as TorchSpeakerIdentification
from voiceprintrecognition_paddlepaddle_tpu.models import layers as jlayers
from voiceprintrecognition_paddlepaddle_tpu.models import pooling as jpool
from voiceprintrecognition_paddlepaddle_tpu.models.campplus import (
    CAMDenseTDNNBlock, TDNNLayer)
from voiceprintrecognition_paddlepaddle_tpu.models.fc import \
    SpeakerIdentification

F_IN = 24
LENGTHS = np.asarray([1.0, 0.73, 0.41], np.float32)

# (backbone, extra arguments over NARROW): the configs' poolings, plus
# the other poolings and switches each backbone takes
CASES = [("TDNN", {}), ("TDNN", dict(pooling_type="SAP")),
         ("EcapaTdnn", {}), ("EcapaTdnn", dict(global_context=False)),
         ("ResNetSE", {}), ("Res2Net", {}),
         ("Res2Net", dict(pooling_type="TSTP", scale=4)),
         ("ERes2Net", {}), ("ERes2NetV2", {}),
         ("ERes2NetV2", dict(two_emb_layer=True))]
_MODELS = {}


def _model(name, extra):
    key = (name, tuple(sorted(extra.items())))
    if key not in _MODELS:
        jm, v, tm = synth_backbone(name, {**NARROW[name], **extra},
                                   input_size=F_IN, seed=len(_MODELS))
        _MODELS[key] = jm, v, tm, jax.jit(
            lambda v_, x, l: jm.apply(v_, x, train=False, lengths=l))
    return _MODELS[key]


def _assert_embed_bar(ref, got):
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    assert cos_min(ref, got) > 0.9999
    assert rel_err(ref, got) < 5e-3


@pytest.mark.parametrize("lengths", [None, LENGTHS], ids=["exact", "lengths"])
@pytest.mark.parametrize(
    "name,extra", CASES,
    ids=[f"{n}-{'-'.join(map(str, e.values())) or 'config'}"
         for n, e in CASES])
def test_backbone_matches_jax(name, extra, lengths):
    _, v, tm, japply = _model(name, extra)
    x = np.random.RandomState(5).randn(3, 61, F_IN).astype(np.float32)
    ref = np.asarray(japply(v, jnp.asarray(x), None if lengths is None
                            else jnp.asarray(lengths)))
    got = tm(torch.from_numpy(x),
             lengths=None if lengths is None else torch.from_numpy(lengths))
    _assert_embed_bar(ref, got.numpy())


@pytest.mark.parametrize("name", sorted(NARROW))
def test_converted_state_covers_every_tensor(name):
    _, v, tm, _ = _model(name, {})
    state = jax_to_torch_state(v)
    assert set(state) == set(tm.state_dict())
    for k, t in tm.state_dict().items():
        assert tuple(state[k].shape) == tuple(t.shape), k


@pytest.mark.parametrize("name", sorted(NARROW))
def test_torch_card_weights_are_in_the_flax_layout(name):
    """``torch_card.random_flax_variables`` (the card tests' weights)
    builds the flax tree of the JAX model, leaf for leaf and shape for
    shape, and converts back into the port's model strictly."""
    import flax

    from torch_card import random_flax_variables
    from voiceprintrecognition_paddlepaddle_torch.models import \
        MODELS as TORCH_MODELS
    from voiceprintrecognition_paddlepaddle_tpu.models import MODELS

    tm = TORCH_MODELS[name](F_IN, **NARROW[name])
    tree = random_flax_variables(tm, 0)
    shapes = flax.core.unfreeze(jax.eval_shape(
        MODELS[name](input_size=F_IN, **NARROW[name]).init,
        jax.random.PRNGKey(0), np.zeros((1, 64, F_IN), np.float32)))
    leaves = jax.tree_util.tree_leaves_with_path
    assert ({jax.tree_util.keystr(p): v.shape for p, v in leaves(tree)}
            == {jax.tree_util.keystr(p): tuple(v.shape)
                for p, v in leaves(shapes)})
    tm.load_state_dict(jax_to_torch_state(tree), strict=True)


def test_unknown_leaf_raises():
    v = _model("TDNN", {})[1]
    bad = {"params": {**v["params"], "Dense_0": {
        **v["params"]["Dense_0"], "gamma": np.ones(3, np.float32)}}}
    with pytest.raises(KeyError, match="Dense_0/gamma"):
        jax_to_torch_state(bad)


def test_ecapa_reflect_pad_needs_more_frames_than_it_pads():
    """The dilation-4 Res2Net convs pad 4 frames: ``jnp.pad`` would
    repeat the reflection on 4 frames, the port raises instead."""
    tm = _model("EcapaTdnn", {})[2]
    with pytest.raises(ValueError, match="reflect padding of 4 frames"):
        tm(torch.zeros(1, 4, F_IN))
    assert tm(torch.zeros(1, 5, F_IN)).shape == (1, 16)


# ---- the poolings alone ----------------------------------------------------
POOL_CASES = [("TAP", {}), ("TSP", {}), ("SAP", {}), ("ASP", {}),
              ("ASP", dict(global_context=False)), ("TSTP", {})]


@pytest.mark.parametrize("lengths", [None, LENGTHS], ids=["exact", "lengths"])
@pytest.mark.parametrize("kind,kw", POOL_CASES,
                         ids=[k + ("-no-context" if kw else "")
                              for k, kw in POOL_CASES])
def test_pooling_matches_jax(kind, kw, lengths):
    x = np.random.RandomState(6).randn(3, 29, 12).astype(np.float32)
    jp = jpool.POOLINGS[kind](**kw)
    tp = tpool.POOLINGS[kind](12, **kw)
    v = synth_flax(jp, tp, x, seed=2)
    lens = None if lengths is None else jnp.asarray(lengths)
    ref = np.asarray(jp.apply(v, jnp.asarray(x), False, lens))
    got = tp(torch.from_numpy(x),
             None if lengths is None else torch.from_numpy(lengths)).numpy()
    assert got.shape == ref.shape == (3, 12 * tpool.POOLING_DIM_FACTOR[kind])
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("lengths", [None, LENGTHS], ids=["exact", "lengths"])
def test_tstp_flattens_nchw_frequency_major(lengths):
    """JAX NHWC ``(B, F, T, C)`` against the port's NCHW ``(B, C, F, T)``:
    the same numbers, flattened ``f * C + c``."""
    x = np.random.RandomState(7).randn(3, 5, 17, 4).astype(np.float32)
    lens = None if lengths is None else jnp.asarray(lengths)
    ref = np.asarray(jpool.TemporalStatsPool().apply({}, jnp.asarray(x),
                                                     False, lens))
    got = tpool.TemporalStatsPool()(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        None if lengths is None else torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_avg_pool_exclusive_matches_jax():
    x = np.random.RandomState(8).randn(2, 7, 9, 3).astype(np.float32)
    for stride in (1, 2):
        ref = np.asarray(jlayers.avg_pool_exclusive(
            jnp.asarray(x), (3, 3), (stride, stride), ((1, 1), (1, 1))))
        got = tlayers.avg_pool_exclusive(
            torch.from_numpy(x).permute(0, 3, 1, 2), 3, stride, 1)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                                   rtol=1e-6, atol=1e-6)


# ---- heads -----------------------------------------------------------------
@pytest.mark.parametrize("config_str", ["batchnorm-relu", "batchnorm",
                                        "prelu", "relu-batchnorm",
                                        "batchnorm-prelu-batchnorm"])
def test_dense_bn_stacks_match_jax(config_str):
    x = np.random.RandomState(9).randn(4, 10).astype(np.float32)
    jm = jlayers.DenseBN(6, config_str=config_str)
    tm = tlayers.DenseBN(10, 6, config_str)
    v = synth_flax(jm, tm, x, seed=3)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), ref,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("classifier_type,K,num_blocks",
                         [("Cosine", 2, 1), ("Cosine", 1, 0),
                          ("Linear", 1, 1)])
def test_speaker_identification_matches_jax(classifier_type, K, num_blocks):
    x = np.random.RandomState(10).randn(5, 16).astype(np.float32)
    jm = SpeakerIdentification(7, classifier_type, K=K, num_blocks=num_blocks,
                               inter_dim=12)
    tm = TorchSpeakerIdentification(16, 7, classifier_type, K=K,
                                    num_blocks=num_blocks, inter_dim=12)
    v = synth_flax(jm, tm, x, seed=4)
    ref = jm.apply(v, jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    assert got["logits"].dtype == torch.float32
    assert got["logits"].shape == ref["logits"].shape == (
        5, 7 * K if classifier_type == "Cosine" else 7)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(ref["logits"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got["features"].numpy(), x)


@pytest.mark.parametrize("config_str", ["batchnorm-prelu", "prelu-batchnorm"])
def test_campplus_head_variants_match_jax(config_str):
    """CAM++ ``config_str`` variants (PReLU stacks), which raised before:
    a CAM dense block of two layers and the TDNN stem, each with every
    nonlinearity of the variant, against the JAX modules."""
    x = np.random.RandomState(11).randn(2, 40, 16).astype(np.float32)
    for jm, tm in (
            (CAMDenseTDNNBlock(2, 8, 16, 3, 2, config_str=config_str),
             TorchCAMDenseTDNNBlock(2, 16, 8, 16, 3, 2, config_str)),
            (TDNNLayer(12, 5, stride=2, config_str=config_str),
             TorchTDNNLayer(16, 12, 5, stride=2, config_str=config_str))):
        v = synth_flax(jm, tm, x, seed=5)
        ref = np.asarray(jm.apply(v, jnp.asarray(x)))
        got = tm(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
