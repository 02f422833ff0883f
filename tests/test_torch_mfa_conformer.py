"""PyTorch port, MFA-Conformer against the benchmark's plain reference
(``benchmark/reference/mfa_conformer.py``) on the CPU, on the benchmark's
seeded weights (``benchmark.weights.model_state``) and ragged lengths: the
backbone and ``Predictor.predict_batch`` at a small width (d 64, 2 heads,
feed-forward 128, 2 blocks, kernel 7) and at the published widths (b2 x
2 s); with the LayerNorm gains at 1 + 0.1 N, the same comparison failing
with bf16-rounded weights, with ``linear_pos`` zeroed and with the key
mask dropped; the backbone's spans and counters."""

import copy
import os

import numpy as np
import pytest
import torch

from benchmark import core, traffic_gen
from benchmark.entries import common
from benchmark.reference import fbank as ref_fbank
from benchmark.weights import model_state
from voiceprintrecognition_paddlepaddle_torch.models import build_model
from voiceprintrecognition_paddlepaddle_torch.models.conformer import MFAConformer
from voiceprintrecognition_paddlepaddle_torch.predict import Predictor
from voiceprintrecognition_paddlepaddle_torch.utils import tracing
from voiceprintrecognition_paddlepaddle_torch.utils.utils import dict_to_object

CPU = torch.device("cpu")
CONFIG = core.load_json(os.path.join(core.HERE, "configs", "mfa_conformer.json"))
SMALL = dict(output_size=64, num_blocks=2, attention_heads=2, linear_units=128,
             cnn_module_kernel=7)
# Both sides compute in fp32 on the CPU from the same features; only the
# order of the sums differs (the fused attention against materialised
# scores): 1.0e-7 to 2.6e-7 measured at both widths, with the seeded gains
# and with gains near 1. With gains near 1, bf16-rounded weights read 4e-3
# to 6e-3, a zeroed linear_pos 1.5e-2 to 3e-2 and the dropped mask 0.35 on
# the ragged clip, so the tolerance, forty times the agreement, still
# separates each by 150x or more.
TOL = 1e-5
# 2 s and 1.24 s clips in the 2 s bucket: the second one is ragged
LENS = np.array([32000, 19840])
PADDED = 32000


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(width):
    c = copy.deepcopy(CONFIG)
    if width == "small":
        c["run"]["model_conf"]["model_args"].update(SMALL)
    return c


def _port(config, state):
    m = MFAConformer(80, **config["run"]["model_conf"]["model_args"])
    m.load_state_dict(state)
    return m.eval()


def _gains_near_one(state):
    """Every LayerNorm gain at 1 + 0.1 N (``weights.py`` draws 0.1 N), so
    that the attention's softmax is far from uniform."""
    return {k: 1.0 + v if "LayerNorm_" in k and k.endswith(".weight") else v
            for k, v in state.items()}


def _case(width, gains="seeded"):
    config = _config(width)
    state = model_state(config, 21, CPU)
    if gains == "near_one":
        state = _gains_near_one(state)
    waves = traffic_gen.waves(LENS, PADDED, 5, CPU)
    ratios = (LENS / PADDED).astype(np.float32)
    return config, state, waves, ratios, common.reference_embeddings(config, state, waves, ratios)


def _bf16(state):
    return {k: v.bfloat16().float() if v.is_floating_point() else v for k, v in state.items()}


def _no_pos(state):
    return {k: torch.zeros_like(v) if ".Dense_4." in k else v for k, v in state.items()}


@pytest.mark.parametrize("gains", ["seeded", "near_one"])
@pytest.mark.parametrize("width", ["small", "published"])
def test_backbone_matches_the_reference(width, gains):
    config, state, waves, ratios, ref = _case(width, gains)
    feats = ref_fbank.features(waves, ratios).float()
    with torch.no_grad():
        got = _port(config, state)(feats, lengths=torch.from_numpy(ratios))
    assert common.rel_err(got, ref).max() < TOL


@pytest.mark.parametrize("width", ["small", "published"])
def test_the_tolerance_binds(width):
    config, state, waves, ratios, ref = _case(width, "near_one")
    feats = ref_fbank.features(waves, ratios).float()
    lengths = torch.from_numpy(ratios)
    with torch.no_grad():
        rounded = _port(config, _bf16(state))(feats, lengths=lengths)
        no_pos = _port(config, _no_pos(state))(feats, lengths=lengths)
        unmasked = _port(config, state)(feats)
    assert common.rel_err(rounded, ref).min() > 30 * TOL
    assert common.rel_err(no_pos, ref).min() > 30 * TOL
    # the full-length clip needs no mask; the ragged one does
    assert common.rel_err(unmasked, ref)[0] < TOL
    assert common.rel_err(unmasked, ref)[1] > 30 * TOL


@pytest.mark.parametrize("width", ["small", "published"])
def test_predict_batch_matches_the_reference(width, tmp_path):
    config, state, waves, ratios, ref = _case(width)
    clips = [waves[i, :n].numpy() for i, n in enumerate(LENS)]
    for name, weights, sound in (("model.pt", state, True),
                                 ("bf16.pt", _bf16(state), False)):
        path = str(tmp_path / name)
        torch.save(weights, path)
        pred = Predictor(config["run"], model_path=path, device="cpu")
        err = common.rel_err(torch.from_numpy(pred.predict_batch(clips, batch_size=2)), ref)
        if sound:
            assert err.max() < TOL
        else:
            assert err.min() > 30 * TOL


def test_the_yaml_builds_the_published_model():
    from voiceprintrecognition_paddlepaddle_torch.utils.config import load_yaml
    conf = load_yaml(os.path.join(core.ROOT, "voiceprintrecognition_paddlepaddle_torch",
                                  "configs", "mfa_conformer.yml"))
    model = build_model(80, dict_to_object(conf))
    assert isinstance(model, MFAConformer)
    assert conf["model_conf"]["model_args"] == CONFIG["run"]["model_conf"]["model_args"]
    state = model.state_dict()
    # the reference's keys: no position table among them
    ref = core.reference(CONFIG).Model(80, **conf["model_conf"]["model_args"])
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert sum(p.numel() for p in model.parameters()) == 19_759_424


def test_spans_nest_as_named_and_the_counters_count():
    config = _config("small")
    model = _port(config, model_state(config, 3, CPU))
    tracing.reset()
    try:
        with tracing.recording(), torch.no_grad():
            model(torch.randn(2, 61, 80), lengths=torch.tensor([1.0, 0.5]))
            model(torch.randn(3, 41, 80))
        spans = tracing.spans()
    finally:
        tracing.reset()
    assert (model.calls, model.rows) == (2, 2 * 30 + 3 * 20)
    names = [s.name for s in spans]
    roots = [k for k, n in enumerate(names) if n == "vpr.conformer"]
    assert len(roots) == 2
    root = roots[0]
    under_root = [s.name for s in spans if s.parent == root]
    assert under_root == ["vpr.conformer.subsample"] + ["vpr.conformer.block"] * 2 + [
        "vpr.conformer.mfa", "vpr.conformer.pool", "vpr.conformer.head"]
    blocks = [k for k, s in enumerate(spans) if s.name == "vpr.conformer.block"]
    assert [spans[k].id for k in blocks] == [0, 1, 0, 1]
    for k in blocks:
        assert [s.name for s in spans if s.parent == k] == [
            "vpr.conformer.ffn", "vpr.conformer.attn", "vpr.conformer.conv",
            "vpr.conformer.ffn"]
    assert len(spans) == 2 * (1 + 1 + 2 * 5 + 3)
    assert all(s.start_ns <= s.end_ns for s in spans)
