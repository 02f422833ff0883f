"""PyTorch port, the slice as a whole: ``Predictor(device="cpu")`` on the
demo wavs against the JAX exact-length embedding (JAX features and
``CAMPPlus.apply`` on the unpadded clip), plus the Predictor's database
surface (register / recognition / contrast / remove_user / retrieve, the
pickle index, the path-traversal guard), the 1, 2, 4, 8 and 16 s
buckets through the FCM kernel's module, the plain branch past the 32 s
bucket, and the choice of path by configuration: a CAM++ off the stock
widths, a dithered Fbank
and each of the six other backbones serve through the plain model, and
match the JAX ``Predictor`` there (cos > 0.9999); an ECAPA-TDNN config
serves over HTTP and through the command-line modules.

The port pads each clip to its bucket and takes the masked path, whose
CAM context is length-aware, so it is compared with the exact-length
embedding and not with the JAX CPU Predictor's padded XLA path. Bar:
cos > 0.999 (``tests/test_pallas_campplus.py:114``).
"""

import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch
import yaml

from flax import serialization

import torch_jax_native  # noqa: F401 (JAX's native library, locked)
from test_torch_helpers import (FULL, NARROW, SMALL, synth_backbone,
                                synth_campplus)
from torch_card import cos_min
from voiceprintrecognition_paddlepaddle_torch import (
    infer_contrast, infer_speaker_diarization, serve)
from voiceprintrecognition_paddlepaddle_torch import predict as tpredict
from voiceprintrecognition_paddlepaddle_torch.models import trunk_kernel as tk
from voiceprintrecognition_paddlepaddle_torch.predict import Predictor
from voiceprintrecognition_paddlepaddle_tpu.ops.audio import \
    AudioSegment as JaxAudioSegment
from voiceprintrecognition_paddlepaddle_tpu.ops.features import \
    compute_feature
from voiceprintrecognition_paddlepaddle_tpu.predict import \
    Predictor as JaxPredictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVS = [os.path.join(ROOT, "dataset", f"{n}.wav")
        for n in ("a_1", "a_2", "b_1", "b_2")]


def _configs():
    with open(os.path.join(ROOT, "configs", "cam++.yml"), encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    return {k: cfg[k] for k in ("dataset_conf", "preprocess_conf",
                                "model_conf")}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads for this file, as ``tests/test_torch_trainer.py``
    has: the suite runs six workers on the host's cores, and torch's
    default pool of one thread per core in each worker oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return synth_campplus(FULL, seed=3)


@pytest.fixture(scope="module")
def world(tmp_path_factory, models):
    jm, v, tm = models
    root = tmp_path_factory.mktemp("torch_predictor")
    model_path = str(root / "model.pt")
    torch.save(tm.state_dict(), model_path)
    japply = jax.jit(lambda x: jm.apply(v, x, train=False))

    def jax_exact(path_or_samples):
        if isinstance(path_or_samples, str):
            seg = JaxAudioSegment.from_file(path_or_samples)
            seg.normalize(target_db=-20)
            samples = seg.samples
        else:
            samples = path_or_samples
        feats = compute_feature(samples[None], "Fbank", sr=16000, n_mels=80)
        return np.asarray(japply(feats))[0]

    return model_path, jax_exact, root


@pytest.fixture(scope="module")
def jax_padded(models):
    """The JAX Predictor's plain branch (``_embed_impl``) on a padded
    batch: masked CMN, then ``CAMPPlus.apply`` with ``lengths``."""
    jm, v, _ = models
    japply = jax.jit(lambda x, r: jm.apply(v, x, train=False, lengths=r))

    def embed(waves, ratios):
        feats = compute_feature(waves, "Fbank", input_lens_ratio=ratios,
                                sr=16000, n_mels=80)
        return np.asarray(japply(feats, ratios))

    return embed


def _predictor(world, db=None, **kw):
    model_path, _, _ = world
    return Predictor(_configs(), model_path=model_path, audio_db_path=db,
                     device="cpu", **kw)


def test_predict_matches_jax_exact_length(world):
    _, jax_exact, _ = world
    pred = _predictor(world)
    for path in WAVS[:3] + [os.path.join(ROOT, "audio_db", "user_a", "0.wav")]:
        got = pred.predict(path)
        assert got.shape == (192,) and np.isfinite(got).all()
        assert cos_min(jax_exact(path)[None], got[None]) > 0.999, path


def test_predict_batch_exact_and_padded_rows_match_jax(world):
    """Two 2 s clips fill their bucket (the exact-length path); a ragged
    batch takes the masked path. Each row holds against JAX's
    exact-length embedding of that clip."""
    _, jax_exact, _ = world
    pred = _predictor(world)
    rng = np.random.RandomState(5)
    exact = [(rng.randn(32000) * 0.05).astype(np.float32) for _ in range(2)]
    ragged = [(rng.randn(n) * 0.05).astype(np.float32)
              for n in (20000, 31000, 9000)]
    for batch in (exact, ragged):
        got = pred.predict_batch(batch)
        assert got.shape == (len(batch), 192)
        for i, s in enumerate(batch):
            assert cos_min(jax_exact(s)[None], got[i:i + 1]) > 0.999, i


def test_database_register_recognize_remove(world):
    _, _, root = world
    db = str(root / "db")
    shutil.copytree(os.path.join(ROOT, "audio_db"), db)
    pred = _predictor(world, db=db, threshold=0.0)
    assert sorted(set(pred.get_users())) == ["user_a", "user_b"]
    ok, msg = pred.register(WAVS[0], "speaker_a")
    assert ok, msg
    assert os.path.exists(os.path.join(db, "speaker_a", "0.wav"))
    name, score = pred.recognition(WAVS[0])
    assert name == "speaker_a" and score > 0.99
    assert -1.0 <= pred.contrast(WAVS[0], WAVS[1]) <= 1.0
    with open(os.path.join(db, "audio_indexes.bin"), "rb") as f:
        index = pickle.load(f)
    assert set(index) == {"users_name", "faces_feature", "users_image_path"}
    assert index["faces_feature"].shape == (3, 192)
    # a fresh Predictor reloads the index instead of re-embedding
    again = _predictor(world, db=db)
    np.testing.assert_allclose(again.audio_feature, pred.audio_feature)
    assert pred.remove_user("speaker_a")
    assert not os.path.exists(os.path.join(db, "speaker_a"))
    assert "speaker_a" not in pred.get_users()


@pytest.mark.parametrize("name", ["../evil", "a/b", "", "x\\y"])
def test_register_rejects_path_traversal(world, name):
    _, _, root = world
    db = str(root / f"db_guard_{abs(hash(name))}")
    pred = _predictor(world, db=db)
    ok, _ = pred.register(WAVS[0], name)
    assert not ok
    assert os.listdir(db) == []


def test_16s_bucket_takes_the_fcm_kernel_and_matches_jax(world, monkeypatch):
    """A 12 s clip pads to the 16 s bucket (1598 frames), so the embed
    goes through ``fcm_fused`` (its plain version on the CPU) and the
    trunk at 799 rows; it holds against JAX's exact-length embedding."""
    _, jax_exact, _ = world
    calls = []
    real = tk.fcm_fused
    monkeypatch.setattr(tk, "fcm_fused",
                        lambda p, f: calls.append(f.shape) or real(p, f))
    pred = _predictor(world)
    clip = (np.random.RandomState(6).randn(192000) * 0.05).astype(np.float32)
    got = pred.predict_batch([clip])
    assert calls == [(1, 1598, 80)]
    assert got.shape == (1, 192) and np.isfinite(got).all()
    assert cos_min(jax_exact(clip)[None], got) > 0.999


@pytest.mark.parametrize("seconds,frames", [(1, 98), (2, 198), (4, 398),
                                            (8, 798)])
def test_each_short_bucket_takes_the_fcm_kernel_and_matches_jax(
        world, monkeypatch, seconds, frames):
    """The embed path takes the FCM kernel at every bucket, as on the
    card: a batch of a clip that fills the ``seconds`` bucket and a
    shorter one (the masked path) goes through ``fcm_fused`` (its plain
    version on the CPU) once, at the bucket's frames, and each clip holds
    against JAX's exact-length embedding."""
    _, jax_exact, _ = world
    calls = []
    real = tk.fcm_fused
    monkeypatch.setattr(tk, "fcm_fused",
                        lambda p, f: calls.append(f.shape) or real(p, f))
    pred = _predictor(world)
    rng = np.random.RandomState(seconds)
    n = seconds * 16000
    clips = [(rng.randn(m) * 0.05).astype(np.float32)
             for m in (n, n * 3 // 4)]
    got = pred.predict_batch(clips)
    assert calls == [(2, frames, 80)]
    assert got.shape == (2, 192) and np.isfinite(got).all()
    for i, clip in enumerate(clips):
        assert cos_min(jax_exact(clip)[None], got[i:i + 1]) > 0.999, i


def test_bucket_past_32s_runs_the_plain_model(world, jax_padded, monkeypatch):
    """Past ``MAX_KERNEL_BUCKET_SAMPLES`` a batch runs the plain
    ``CAMPPlus.forward`` with length ratios, as the JAX Predictor's
    ``_embed_impl`` does; the choice depends on the bucket length alone.
    The limit is lowered here so that the branch runs at a 4 s bucket."""
    monkeypatch.setattr(tpredict, "MAX_KERNEL_BUCKET_SAMPLES", 32000)
    pred = _predictor(world)
    kernel_calls = []
    real = pred._embed
    pred._embed = lambda *a: kernel_calls.append(a) or real(*a)
    rng = np.random.RandomState(7)
    clips = [(rng.randn(n) * 0.05).astype(np.float32) for n in (48000, 30000)]
    got = pred.predict_batch(clips)
    assert kernel_calls == []
    waves = np.zeros((2, 64000), np.float32)
    for i, c in enumerate(clips):
        waves[i, :len(c)] = c
    ratios = np.asarray([len(c) / 64000 for c in clips], np.float32)
    ref = jax_padded(waves, ratios)
    assert got.shape == (2, 192)
    assert cos_min(ref, got) > 0.999
    # a 2 s bucket stays on the kernel path
    pred.predict_batch([clips[1][:20000]])
    assert len(kernel_calls) == 1


def test_configs_from_yaml_path(world, tmp_path):
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(_configs()))
    model_path, _, _ = world
    pred = Predictor(str(path), model_path=model_path, device="cpu")
    assert pred.predict(WAVS[0]).shape == (192,)


def test_cuda_device_without_cuda_raises(world):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model_path, _, _ = world
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(_configs(), model_path=model_path)


def test_retrieve_threshold_is_per_call(world, tmp_path):
    db = str(tmp_path / "db")
    shutil.copytree(os.path.join(ROOT, "audio_db"), db)
    pred = _predictor(world, db=db, threshold=0.6)
    emb = pred.predict(os.path.join(db, "user_a", "0.wav"))[None]
    assert pred.retrieve(emb)[0][0] == "user_a"
    assert pred.retrieve(emb, threshold=1.01) == [[None, None]]
    assert pred.threshold == 0.6
    name, score = pred.retrieve(emb, threshold=0.0)[0]
    assert name == "user_a" and score > 0.99


def test_stock_config_takes_the_kernel_path(world, monkeypatch):
    pred = _predictor(world)
    assert pred._embed is not None
    plain = []
    monkeypatch.setattr(pred, "_embed_plain",
                        lambda *a: plain.append(a) or pytest.fail("plain"))
    pred.predict(WAVS[0])
    assert plain == []


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    """A CAM++ at ``init_channels: 32`` (the tiny config of the verify
    recipe), saved for both Predictors."""
    _, v, tm = synth_campplus(SMALL, seed=4)
    root = tmp_path_factory.mktemp("narrow")
    torch.save(tm.state_dict(), str(root / "model.pt"))
    (root / "model.msgpack").write_bytes(serialization.msgpack_serialize(v))
    cfg = _configs()
    cfg["model_conf"] = dict(cfg["model_conf"], model_args=dict(SMALL))
    return cfg, str(root / "model.pt"), str(root / "model.msgpack")


def test_narrow_campplus_serves_and_matches_jax(narrow, monkeypatch):
    """The port's Predictor used to build the kernel path for any CAM++
    and raised ``NotImplementedError`` at construction for this one; as in
    the JAX ``_maybe_make_fast_embed`` it now runs the plain model, with
    length ratios, for every batch."""
    cfg, pt, msgpack = narrow
    monkeypatch.setattr(
        tpredict, "make_campplus_masked_embed_fn",
        lambda *a: pytest.fail("the kernel path was built"))
    pred = Predictor(cfg, model_path=pt, device="cpu")
    assert pred._embed is None
    jpred = JaxPredictor(cfg, model_path=msgpack, use_gpu=False)
    rng = np.random.RandomState(8)
    clips = [(rng.randn(n) * 0.05).astype(np.float32)
             for n in (16000, 20000, 31000, 9000)]
    got = pred.predict_batch(clips)
    want = jpred.predict_batch(clips)
    assert got.shape == want.shape == (4, 32)
    assert cos_min(want, got) > 0.9999
    one = pred.predict(WAVS[0])
    assert cos_min(jpred.predict(WAVS[0])[None], one[None]) > 0.9999



def test_dither_keeps_the_kernel_path_off(world, monkeypatch):
    """As JAX ``predict.py:132``: a dithered Fbank front end never builds
    the kernel path. The plain path draws its dither from a generator
    seeded 0 for every batch (JAX's fixed key), so a batch embeds the same
    twice, close to but not at the undithered embedding."""
    model_path, _, _ = world
    cfg = _configs()
    cfg["preprocess_conf"] = {"feature_method": "Fbank", "method_args": {
        "sr": 16000, "n_mels": 80, "dither": 1e-4}}
    rng = np.random.RandomState(9)
    clips = [(rng.randn(n) * 0.1).astype(np.float32) for n in (16000, 12000)]
    undithered = _predictor(world).predict_batch(clips)
    monkeypatch.setattr(
        tpredict, "make_campplus_masked_embed_fn",
        lambda *a: pytest.fail("the kernel path was built"))
    pred = Predictor(cfg, model_path=model_path, device="cpu")
    assert pred._embed is None and pred._audio_featurizer.dither == 1e-4
    got = pred.predict_batch(clips)
    np.testing.assert_array_equal(got, pred.predict_batch(clips))
    assert not np.array_equal(got, undithered)
    assert cos_min(undithered, got) > 0.99


def _save_backbone(name, root, seed):
    """A narrow ``name`` with seeded weights, saved for both Predictors,
    and its configuration (configs/cam++.yml's with ``model_conf``
    replaced)."""
    _, v, tm = synth_backbone(name, NARROW[name], input_size=80, seed=seed)
    torch.save(tm.state_dict(), str(root / "model.pt"))
    (root / "model.msgpack").write_bytes(serialization.msgpack_serialize(v))
    cfg = _configs()
    cfg["model_conf"] = {"model": name, "model_args": {
        k: list(a) if isinstance(a, tuple) else a
        for k, a in NARROW[name].items()}}
    return cfg, str(root / "model.pt"), str(root / "model.msgpack")


@pytest.mark.parametrize("name", sorted(NARROW))
def test_backbone_serves_and_matches_jax(name, tmp_path, monkeypatch):
    """Each of the six other backbones (lists in ``model_args``, as YAML
    gives them) through ``Predictor(device="cpu")``, the plain model with
    length ratios on ragged clips padded to their bucket, against the JAX
    ``Predictor`` on the same weights."""
    cfg, pt, msgpack = _save_backbone(name, tmp_path, seed=20)
    monkeypatch.setattr(
        tpredict, "make_campplus_masked_embed_fn",
        lambda *a: pytest.fail("the kernel path was built"))
    pred = Predictor(cfg, model_path=pt, device="cpu")
    assert type(pred.model).__name__ == name and pred._embed is None
    jpred = JaxPredictor(cfg, model_path=msgpack, use_gpu=False)
    rng = np.random.RandomState(8)
    clips = [(rng.randn(n) * 0.05).astype(np.float32)
             for n in (16000, 20000, 31000, 9000)]
    got = pred.predict_batch(clips)
    want = jpred.predict_batch(clips)
    assert got.shape == want.shape == (4, 16)
    assert cos_min(want, got) > 0.9999


def test_ecapa_config_serves_over_http_and_the_command_lines(tmp_path,
                                                             capsys):
    """``serve.py``, ``infer_contrast.py`` and
    ``infer_speaker_diarization.py`` need no code of their own for another
    backbone: an ECAPA-TDNN config serves every one on the CPU."""
    import threading
    import urllib.request

    cfg, pt, _ = _save_backbone("EcapaTdnn", tmp_path, seed=21)
    db = str(tmp_path / "db")
    shutil.copytree(os.path.join(ROOT, "audio_db"), db,
                    ignore=shutil.ignore_patterns("audio_indexes.bin"))
    pred = Predictor(cfg, model_path=pt, audio_db_path=db, threshold=0.0,
                     device="cpu")
    httpd = serve.ServingHTTPServer(("127.0.0.1", 0), serve.make_handler(pred))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, body):
        req = urllib.request.Request(url + path, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return yaml.safe_load(r.read())

    try:
        with open(WAVS[0], "rb") as f:
            body = f.read()
        emb = np.asarray(post("/embedding", body)["embedding"], np.float32)
        assert emb.shape == (16,)
        assert cos_min(pred.predict(WAVS[0])[None], emb[None]) > 0.9999
        assert post("/recognition", body)["name"] in ("user_a", "user_b")
        segs = post("/diarization?speakers=2", open(
            os.path.join(ROOT, "dataset", "test_long.wav"), "rb").read())
        assert segs["segments"]
    finally:
        httpd.shutdown()
        httpd.server_close()
    path = tmp_path / "ecapa.yml"
    path.write_text(yaml.safe_dump(cfg), encoding="utf-8")
    score = infer_contrast.main([f"--configs={path}", "--device=cpu",
                                 f"--model_path={pt}",
                                 f"--audio_path1={WAVS[0]}",
                                 f"--audio_path2={WAVS[0]}"])
    assert score > 0.999
    out = infer_speaker_diarization.main([
        f"--configs={path}", "--device=cpu", f"--model_path={pt}",
        f"--audio_path={os.path.join(ROOT, 'dataset', 'test_long.wav')}",
        f"--audio_db_path={db}", "--search_audio_db=True", "--threshold=0",
        "--speaker_num=2"])
    assert out and all(isinstance(s["speaker"], str) for s in out)
    assert "diarization results:" in capsys.readouterr().out
