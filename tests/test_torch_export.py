"""PyTorch port, ``Trainer.extract_features`` and ``Trainer.export``
against the JAX package's trainer.

``extract_features``: the port and the JAX trainer over copies of the
same three lists write the same ``*_features.txt`` lists (in order: the
label directory and the utterance counter of each path, the label) and
``.npy`` arrays within the feature tests' log bar (max |d| < 2e-2, 99th
percentile < 1e-3: the port's plain fbank against XLA's).

``export``: a tiny TDNN here and a tiny CAM++ (all 52 layers) in
``tests/test_torch_export_campplus.py`` (its export, save and load take
about a minute on the CPU: ``torch.export.load`` parses the symbolic size
of each of its 2,400 nodes), with seeded weights (``synth_backbone`` /
``synth_campplus``), exported with a symbolic batch and length
(``export_batch=None, export_seconds=None``). ``torch.export.load`` of
``model.pt2`` runs at batches 1 and 3 and at 211 and 402 frames
(``160*f + 240`` samples: two CAM++ context segments after its stride-2
stem, then three; the CAM++ program takes 201 frames and up,
``Trainer._export_min_frames``) against
the JAX backbone's forward on ``compute_feature(..., use_pallas=False)``
(at batch 3; batch 1 is its first clip): cos >= 0.9999 and 5e-3
relative, the eager CAM++ bar. ``inference.json`` has the JAX bundle's
keys and values, and ``Predictor(model_path=infer_dir, device="cpu")``
serves the exported ``model.pt``."""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from test_torch_helpers import (NARROW, SMALL, rel_err, speaker_corpus,
                                synth_backbone, synth_campplus, train_configs)
from torch_card import cos_min
from voiceprintrecognition_paddlepaddle_torch.predict import Predictor
from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer
from voiceprintrecognition_paddlepaddle_tpu.ops.features import \
    compute_feature
from voiceprintrecognition_paddlepaddle_tpu.trainer import \
    Trainer as JaxTrainer

CASES = {"TDNN": (NARROW["TDNN"], 40), "CAMPPlus": (SMALL, 80)}
LISTS = ("train_list", "enroll_list", "trials_list")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads, as the other training test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    return speaker_corpus(tmp_path_factory.mktemp("corpus"), n_utts=4,
                          seconds=(0.8, 2.5))


def _cfg(lists, name, root=None):
    args, n_mels = CASES[name]
    cfg = train_configs(lists, model=name, model_args=dict(args),
                        n_mels=n_mels)
    if root is not None:            # copies of the lists under root
        os.makedirs(root, exist_ok=True)
        for key in LISTS:
            dst = os.path.join(root, os.path.basename(
                cfg["dataset_conf"][key]))
            shutil.copy(cfg["dataset_conf"][key], dst)
            cfg["dataset_conf"][key] = dst
    return cfg


def _read_list(path):
    """``*_features.txt`` -> [(label dir, counter, label, path)]."""
    out = []
    for line in open(path, encoding="utf-8").read().splitlines():
        p, label = line.split("\t")
        counter = os.path.basename(p).rsplit("_", 1)[1]
        out.append((os.path.basename(os.path.dirname(p)), counter, label, p))
    return out


def test_extract_features_matches_jax(lists, tmp_path):
    sides = {}
    for side in ("jax", "port"):
        cfg = _cfg(lists, "TDNN", root=str(tmp_path / side / "lists"))
        save = str(tmp_path / side / "features")
        if side == "jax":
            JaxTrainer(cfg, use_gpu=False).extract_features(save_dir=save)
        else:
            Trainer(cfg, device="cpu").extract_features(save_dir=save)
        sides[side] = [_read_list(cfg["dataset_conf"][k].replace(
            ".txt", "_features.txt")) for k in LISTS]
    n = 0
    for ref, got in zip(sides["jax"], sides["port"]):
        assert [r[:3] for r in ref] == [g[:3] for g in got]
        for r, g in zip(ref, got):
            a, b = np.load(r[3]), np.load(g[3])
            assert b.dtype == np.float32 and a.shape == b.shape
            assert a.shape[1] == 40 and np.isfinite(b).all()
            d = np.abs(a - b)
            assert d.max() < 2e-2 and np.percentile(d, 99) < 1e-3, r[3]
            n += 1
    assert n == 16 + 8 + 8


@pytest.mark.parametrize("name", ["TDNN"])
def test_export_matches_jax(lists, tmp_path, name):
    check_export(lists, tmp_path, name)


def test_export_of_a_centred_stft_method(lists, tmp_path):
    """MelSpectrogram: the symbolic length is ``hop*f`` samples (JAX
    ``trainer.py:1036-1038``) with the featurizer's hop, 128 (``n_fft //
    4``) when the config sets none, at 64 mels."""
    check_export(lists, tmp_path, "TDNN", method="MelSpectrogram")


def check_export(lists, tmp_path, name, method="Fbank"):
    args, n_mels = CASES[name]
    if method != "Fbank":
        n_mels = 64
    if name == "CAMPPlus":
        jm, v, tm = synth_campplus(args, input_size=n_mels, seed=2)
    else:
        jm, v, tm = synth_backbone(name, args, input_size=n_mels, seed=2)
    weights = tmp_path / "weights"
    weights.mkdir()
    torch.save(tm.state_dict(), weights / "model.pt")
    cfg = _cfg(lists, name)
    cfg["preprocess_conf"] = {"feature_method": method,
                              "method_args": {"sr": 16000, "n_mels": n_mels}}
    tr = Trainer(cfg, device="cpu")
    infer = tr.export(save_model_path=str(tmp_path / "out"),
                      resume_model=str(weights), export_batch=None,
                      export_seconds=None)
    assert infer == os.path.join(str(tmp_path / "out"), f"{name}_{method}",
                                 "infer")
    assert sorted(os.listdir(infer)) == ["inference.json", "model.pt",
                                         "model.pt2"]
    program = torch.export.load(os.path.join(infer, "model.pt2")).module()
    method_args = cfg["preprocess_conf"]["method_args"]
    extra = {"use_pallas": False} if method == "Fbank" else {}
    forward = jax.jit(lambda w: jm.apply(v, compute_feature(
        w, method, **extra, **method_args), train=False))
    rng = np.random.RandomState(4)
    length = (lambda f: 160 * f + 240) if method == "Fbank" else \
        (lambda f: 128 * f)
    for f in (211, 402):
        w = (rng.randn(3, length(f)) * 0.1).astype(np.float32)
        ref = np.asarray(forward(w))
        for b in (1, 3):
            with torch.no_grad():
                got = program(torch.from_numpy(w[:b])).numpy()
            assert got.shape == ref[:b].shape == (b, args["embd_dim"])
            assert cos_min(ref[:b], got) > 0.9999, (b, f)
            assert rel_err(ref[:b], got) < 5e-3, (b, f)
    with open(os.path.join(infer, "inference.json"), encoding="utf-8") as fh:
        info = json.load(fh)
    if name == "TDNN" and method == "Fbank":
        # the JAX bundle of the same config (its StableHLO export is quick
        # for a TDNN)
        jinfer = JaxTrainer(cfg, use_gpu=False).export(
            save_model_path=str(tmp_path / "jax"), resume_model=None,
            export_batch=None, export_seconds=None)
        with open(os.path.join(jinfer, "inference.json"),
                  encoding="utf-8") as fh:
            assert info == json.load(fh)
    assert info == {"model": name, "feature_method": method,
                    "export_batch": None, "export_seconds": None}
    pred = Predictor(cfg, model_path=infer, device="cpu")
    clip = (rng.randn(length(250)) * 0.1).astype(np.float32)
    with torch.no_grad():
        want = program(torch.from_numpy(clip[None])).numpy()
    assert cos_min(want, pred.predict(clip)[None]) > 0.9999
