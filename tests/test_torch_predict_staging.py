"""PyTorch port, ``Predictor.predict_batch``'s staging on the CPU: every
chunk is staged once, each row's tail and the rows past the chunk are
written (a staging filled with NaN beforehand gives the same
embeddings), and the embeddings are bit for bit those of a zeroed
pageable numpy staging (``np.zeros``, the fill, a blocking copy, the
plain model with numpy ratios; ``zeroed_staging_embeddings``, which
``tests/test_torch_gpu.py`` holds the card to as well). ERes2Net and
ECAPA-TDNN at narrow widths, on one device and split over two CPU
devices with padding rows; the counters, also from many threads on one
Predictor. This file imports no jax."""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from voiceprintrecognition_paddlepaddle_torch.data_utils.collate import \
    bucket_length
from voiceprintrecognition_paddlepaddle_torch.models import build_model
from voiceprintrecognition_paddlepaddle_torch.predict import Predictor
from voiceprintrecognition_paddlepaddle_torch.utils.config import load_yaml
from voiceprintrecognition_paddlepaddle_torch.utils.utils import \
    dict_to_object

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_FILES = {"ERes2Net": "eres2net.yml", "EcapaTdnn": "ecapa_tdnn.yml"}
# an exact 2 s bucket, short clips, an exact 1 s bucket, a clip under 1 s
LENS = (32000, 20000, 16000, 9000, 27000)


def zeroed_staging_embeddings(pred, clips, batch_size):
    """``pred``'s embeddings of ``clips`` staged in zeroed pageable numpy
    memory: per chunk a fresh ``np.zeros`` padded to the bucket
    (``n_dev`` x a power of two rows when split), ratios 1 on padding
    rows, a blocking copy of each replica's share, and the plain model
    with numpy ratios (the masked CMN and ``lengths`` each copied from
    the host)."""
    n_dev = len(pred._replicas)
    out = []
    for i in range(0, len(clips), batch_size):
        chunk = clips[i:i + batch_size]
        max_len = bucket_length(max(len(s) for s in chunk))
        use_dp = n_dev > 1 and len(chunk) >= n_dev
        b_pad = n_dev if use_dp else len(chunk)
        while b_pad < len(chunk):
            b_pad *= 2
        waves = np.zeros((b_pad, max_len), np.float32)
        ratios = np.ones((b_pad,), np.float32)
        for j, s in enumerate(chunk):
            waves[j, :len(s)] = s
            ratios[j] = len(s) / max_len
        share = b_pad // n_dev if use_dp else b_pad
        embs = []
        for r in range(b_pad // share):
            dev, model, _ = pred._replicas[r]
            w = torch.from_numpy(waves[r * share:(r + 1) * share]).to(dev)
            rat = ratios[r * share:(r + 1) * share]
            with torch.no_grad():
                feats = pred._audio_featurizer(w, input_lens_ratio=rat)
                lengths = torch.from_numpy(rat).to(dev)
                embs.append(model(feats, lengths=lengths).float().cpu())
        out.append(torch.cat(embs)[:len(chunk)].numpy())
    return np.concatenate(out)


def clips_of(lens, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(n) * 0.1).astype(np.float32) for n in lens]


def nan_staging(pred, monkeypatch):
    """Make ``pred``'s staging start as NaN, so that an element the fill
    leaves unwritten shows in the embeddings."""
    staging = pred._staging

    def poisoned(*shape):
        waves, ratios = staging(*shape)
        waves.fill_(float("nan"))
        ratios.fill_(float("nan"))
        return waves, ratios
    monkeypatch.setattr(pred, "_staging", poisoned)


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def narrow_paths(tmp_path_factory):
    """Each backbone's config at the narrow widths of the parity tests,
    with seeded initial weights saved: {name: (config, model path)}."""
    from test_torch_helpers import NARROW

    root = tmp_path_factory.mktemp("staging")
    out = {}
    for name, file in CONFIG_FILES.items():
        cfg = load_yaml(os.path.join(ROOT, "configs", file))
        cfg["model_conf"]["model_args"] = dict(
            cfg["model_conf"]["model_args"], **NARROW[name])
        torch.manual_seed(5)
        path = str(root / f"{name}.pt")
        torch.save(build_model(80, dict_to_object(cfg)).state_dict(), path)
        out[name] = (cfg, path)
    return out


def _predictor(narrow_paths, name, split=False):
    cfg, path = narrow_paths[name]
    if split:
        return Predictor(cfg, model_path=path, device="cpu",
                         data_parallel=True, devices=["cpu", "cpu"])
    return Predictor(cfg, model_path=path, device="cpu")


@pytest.mark.parametrize("split", [False, True], ids=["one", "split"])
@pytest.mark.parametrize("name", list(CONFIG_FILES))
def test_predict_batch_matches_the_zeroed_staging(narrow_paths, name, split,
                                                  monkeypatch):
    """Chunks of 3 then 2 clips (split: 4 rows with one padding row, then
    2); unsplit chunks of 2, 2 and 1. Then the same clips again on a
    staging filled with NaN."""
    pred = _predictor(narrow_paths, name, split)
    assert pred._embed is None
    clips = clips_of(LENS, 7)
    batch_size = 3 if split else 2
    want = zeroed_staging_embeddings(pred, clips, batch_size)
    got = pred.predict_batch(clips, batch_size=batch_size)
    assert got.shape == (len(LENS), 16)
    assert np.array_equal(got, want)
    nan_staging(pred, monkeypatch)
    assert np.array_equal(pred.predict_batch(clips, batch_size=batch_size),
                          want)
    n = 2 * (2 if split else 3)
    assert (pred.chunks, pred.pinned_chunks) == (n, 0)


def test_stage_writes_every_row_and_ratio(narrow_paths, monkeypatch):
    pred = _predictor(narrow_paths, "ERes2Net")
    nan_staging(pred, monkeypatch)
    chunk = clips_of((20000, 32000, 7000), 3)
    waves, ratios = pred._stage(chunk, 4)
    assert waves.shape == (4, 32000) and not waves.is_pinned()
    want = np.zeros((4, 32000), np.float32)
    for j, s in enumerate(chunk):
        want[j, :len(s)] = s
    assert np.array_equal(waves.numpy(), want)
    assert np.array_equal(ratios.numpy(), np.array(
        [20000 / 32000, 1.0, 7000 / 32000, 1.0], np.float32))
    assert (pred.chunks, pred.pinned_chunks) == (1, 0)


def test_many_threads_count_every_chunk_and_get_serial_answers(narrow_paths):
    """Eight threads, three calls each of two chunks, on one Predictor
    with a short switch interval: the counters lose no chunk and every
    answer is the serial call's."""
    pred = _predictor(narrow_paths, "ERes2Net")
    inputs = [clips_of((16000 + 1000 * t, 9000, 12000 - 500 * t), 20 + t)
              for t in range(8)]
    serial = [pred.predict_batch(c, batch_size=2) for c in inputs]
    base = pred.chunks
    results = [[] for _ in inputs]
    errors = []

    def work(t):
        try:
            for _ in range(3):
                results[t].append(pred.predict_batch(inputs[t], batch_size=2))
        except Exception as e:             # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(len(inputs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    for want, got in zip(serial, results):
        assert len(got) == 3 and all(np.array_equal(g, want) for g in got)
    assert (pred.chunks - base, pred.pinned_chunks) == (8 * 3 * 2, 0)


def test_embed_fn_counts_its_calls_and_pins_nothing_on_the_cpu(tmp_path):
    """The stock CAM++ takes the kernel path's embed function, which on
    CPU tensors runs its kernels' plain versions: every call counts in
    ``calls``, none in ``pinned_calls`` (nothing goes to a card), and
    numpy ratios and a CPU tensor of them give the same embeddings."""
    cfg = load_yaml(os.path.join(ROOT, "configs", "cam++.yml"))
    torch.manual_seed(0)
    path = str(tmp_path / "model.pt")
    torch.save(build_model(80, dict_to_object(cfg)).state_dict(), path)
    pred = Predictor(cfg, model_path=path, device="cpu")
    embed = pred._embed
    assert (embed.calls, embed.pinned_calls) == (0, 0)
    waves, ratios = pred._stage(clips_of((16000, 9000), 8), 2)
    from_numpy = embed(waves, ratios.numpy())
    assert torch.equal(embed(waves, ratios), from_numpy)
    assert embed(waves[:1], None).shape == (1, 192)
    assert (embed.calls, embed.pinned_calls) == (3, 0)
    pred.predict_batch(clips_of((16000, 9000, 12000), 9), batch_size=2)
    assert (embed.calls, embed.pinned_calls) == (5, 0)
