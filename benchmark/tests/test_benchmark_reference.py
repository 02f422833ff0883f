"""The plain reference against the port's plain modules on the CPU, on
seeded weights: at a small width for the models, at the stock width on
two short clips for the kernel path's masked function; and the controls
(the reference a step down in precision) against each configuration's
limit."""

import numpy as np
import pytest
import torch

from benchmark import core, traffic_gen
from benchmark.entries import common
from benchmark.reference import fbank as ref_fbank
from benchmark.reference.campplus import CAMPPlus as RefCAMPPlus, tvalids
from benchmark.reference.eres2net import ERes2Net as RefERes2Net
from benchmark.weights import model_state, seeded_state
from voiceprintrecognition_paddlepaddle_torch.models.campplus import CAMPPlus
from voiceprintrecognition_paddlepaddle_torch.models.eres2net import ERes2Net
from voiceprintrecognition_paddlepaddle_torch.ops import kaldi
from voiceprintrecognition_paddlepaddle_torch.ops.features import apply_cmn_and_mask

CPU = torch.device("cpu")


def _clips(n, seed=7, padded=64000):
    lens = traffic_gen.lengths({"clip_seconds": [2.0, 4.0]}, n, seed)
    return lens, traffic_gen.waves(lens, padded, seed, CPU), (lens / padded).astype(np.float32)


def test_fbank_and_cmn_match_the_port():
    lens, w, r = _clips(3)
    got = kaldi.fbank(w, sr=16000, n_mels=80)
    want = ref_fbank.fbank(w)
    assert torch.allclose(got.double(), want, atol=2e-3)
    assert torch.allclose(apply_cmn_and_mask(want, torch.from_numpy(r)),
                          ref_fbank.cmn(want, r), atol=1e-12)


def _same_state(ref, port, seed):
    state = seeded_state({k: tuple(v.shape) for k, v in ref.state_dict().items()}, seed, CPU)
    ref.load_state_dict(state)
    port.load_state_dict(state)


@pytest.mark.parametrize("train", [False, True])
def test_campplus_matches_the_port_small(train):
    ref = RefCAMPPlus(80, embd_dim=32, growth_rate=16, bn_size=2, init_channels=32)
    port = CAMPPlus(80, embd_dim=32, growth_rate=16, bn_size=2, init_channels=32)
    _same_state(ref, port, 11)
    ref.train(train), port.train(train)
    x = torch.randn(3, 230, 80)
    lengths = torch.tensor([1.0, 0.8, 0.55])
    a, b = port(x, lengths=lengths), ref(x, lengths)
    assert float((a - b).norm() / b.norm()) < 1e-5


@pytest.mark.parametrize("train", [False, True])
def test_eres2net_matches_the_port_small(train):
    ref, port = RefERes2Net(80, m_channels=8, embd_dim=16), ERes2Net(80, m_channels=8, embd_dim=16)
    _same_state(ref, port, 12)
    ref.train(train), port.train(train)
    x = torch.randn(3, 120, 80)
    lengths = torch.tensor([1.0, 0.7, 0.5])
    a, b = port(x, lengths=lengths), ref(x, lengths)
    assert float((a - b).norm() / b.norm()) < 1e-5


def test_masked_campplus_matches_the_kernel_path_plain_versions():
    """The port's kernel path on the CPU runs its kernels' plain versions,
    which round to bf16 where the kernels do."""
    from voiceprintrecognition_paddlepaddle_torch.models.trunk_kernel import (
        make_campplus_masked_embed_fn)
    from voiceprintrecognition_paddlepaddle_torch.ops.features import AudioFeaturizer
    config = core.load_json(f"{core.HERE}/configs/campplus.json")
    state = model_state(config, 13, CPU)
    port = CAMPPlus(80, embd_dim=192)
    port.load_state_dict(state)
    port.eval()
    embed = make_campplus_masked_embed_fn(port, AudioFeaturizer("Fbank", {"sr": 16000, "n_mels": 80}))
    lens, w, r = _clips(2)
    got = embed(w, r)
    want = common.reference_embeddings(config, state, w, r)
    assert common.rel_err(got, want).max() < 5e-3
    assert tvalids(r, 398).tolist() == np.clip(np.ceil(r * np.float32(199)), 1, 199).astype(int).tolist()


@pytest.mark.parametrize("name", ["campplus", "eres2net"])
def test_control_fails_the_limit(name):
    config = core.load_json(f"{core.HERE}/configs/{name}.json")
    state = model_state(config, 14, CPU)
    _, w, r = _clips(2)
    ref = common.reference_embeddings(config, state, w, r)
    low = common.reference_embeddings(config, state, w, r, config["control"])
    assert common.rel_err(low, ref).max() > config["limits"]["embed_rel_err"]
