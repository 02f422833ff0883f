"""PyTorch port, ECAPA-TDNN against the benchmark's plain reference
(``benchmark/reference/ecapa_tdnn.py``) on the CPU, on the benchmark's
seeded weights (``benchmark.weights.model_state``) and ragged lengths: the
backbone and ``Predictor.predict_batch`` at a small width (channels
64/64/64/64/192, Res2Net scale 4) and at the published widths (C = 1024,
b2 x 2 s); the same comparison failing with bf16-rounded weights and
with the lengths dropped; and the backbone's spans."""

import copy
import os

import numpy as np
import pytest
import torch

from benchmark import core, traffic_gen
from benchmark.entries import common
from benchmark.reference import fbank as ref_fbank
from benchmark.weights import model_state
from voiceprintrecognition_paddlepaddle_torch.models.ecapa_tdnn import EcapaTdnn
from voiceprintrecognition_paddlepaddle_torch.predict import Predictor
from voiceprintrecognition_paddlepaddle_torch.utils import tracing

CPU = torch.device("cpu")
CONFIG = core.load_json(os.path.join(core.HERE, "configs", "ecapa_tdnn_c1024.json"))
# Both sides compute in fp32 on the CPU from the same features, so only the
# order of the sums differs: 2e-7 to 5e-7 measured at both widths. A bf16
# cast of the weights reads 3e-3 and dropping the lengths 0.2, so the
# tolerance, at twenty times the agreement, still separates them by 300x.
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
        c["run"]["model_conf"]["model_args"].update(channels=[64, 64, 64, 64, 192],
                                                    res2net_scale=4)
    return c


def _port(config, state):
    args = {k: tuple(v) if isinstance(v, list) else v
            for k, v in config["run"]["model_conf"]["model_args"].items()}
    m = EcapaTdnn(80, **args)
    m.load_state_dict(state)
    return m.eval()


def _case(width):
    config = _config(width)
    state = model_state(config, 21, CPU)
    waves = traffic_gen.waves(LENS, PADDED, 5, CPU)
    ratios = (LENS / PADDED).astype(np.float32)
    return config, state, waves, ratios, common.reference_embeddings(config, state, waves, ratios)


def _bf16(state):
    return {k: v.bfloat16().float() if v.is_floating_point() else v for k, v in state.items()}


@pytest.mark.parametrize("width", ["small", "published"])
def test_backbone_matches_the_reference_and_the_tolerance_binds(width):
    config, state, waves, ratios, ref = _case(width)
    feats = ref_fbank.features(waves, ratios).float()
    lengths = torch.from_numpy(ratios)
    with torch.no_grad():
        got = _port(config, state)(feats, lengths=lengths)
        rounded = _port(config, _bf16(state))(feats, lengths=lengths)
        unmasked = _port(config, state)(feats)
    assert common.rel_err(got, ref).max() < TOL
    assert common.rel_err(rounded, ref).max() > 30 * TOL
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


def test_spans_nest_as_named():
    config = _config("small")
    model = _port(config, model_state(config, 3, CPU))
    tracing.reset()
    try:
        with tracing.recording(), torch.no_grad():
            model(torch.randn(2, 60, 80), lengths=torch.tensor([1.0, 0.5]))
        spans = tracing.spans()
    finally:
        tracing.reset()
    names = [s.name for s in spans]
    assert names.count("vpr.ecapa") == 1
    root = names.index("vpr.ecapa")
    under_root = [s.name for s in spans if s.parent == root]
    assert under_root == ["vpr.ecapa.front"] + ["vpr.ecapa.block"] * 3 + [
        "vpr.ecapa.mfa", "vpr.ecapa.pool", "vpr.ecapa.head"]
    blocks = [k for k, s in enumerate(spans) if s.name == "vpr.ecapa.block"]
    assert [spans[k].id for k in blocks] == [0, 1, 2]
    for k in blocks:
        assert [s.name for s in spans if s.parent == k] == ["vpr.ecapa.res2net",
                                                              "vpr.ecapa.se"]
    assert len(spans) == 14
    assert all(s.start_ns <= s.end_ns for s in spans)
