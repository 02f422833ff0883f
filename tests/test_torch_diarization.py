"""PyTorch port, speaker diarization against the JAX package, stage by
stage (random-weight embeddings sit close together, so the labels of a
whole run are a weak check on their own):

- VAD segments and 1.5 s chunks: equal;
- the spectral stages (similarity, p-pruning, Laplacian, eigenvalues,
  eigen-gap count): allclose at rtol 1e-6, the count equal;
- k-means (written in the port; the JAX package calls scikit-learn's):
  the same partition on seeded blobs, with and without an oracle count;
  one seed, one labelling;
- centroid merge, clustering centres and postprocess: exact;
- each chunk embedding of ``Predictor(device="cpu").speaker_diarization``
  (the masked kernel path: 24,000-sample chunks in the 32,000-sample
  bucket) against JAX's exact-length embedding of that chunk: cos > 0.999
  (``tests/test_pallas_campplus.py:114``);
- a whole run on a tone / noise scene against the JAX Predictor's, on a
  model whose BN statistics were calibrated on such audio so that the two
  speakers separate: equal up to relabelling, boundaries within 0.01 s;
- DER and RTTM: equal to 1e-9.
"""

import io
import os

import jax
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

import torch_jax_native  # noqa: F401 (JAX's native library, locked)
from test_torch_helpers import (FULL, calibrate_bn_stats, calibration_clips,
                                cos_min, synth_campplus, tone)
from voiceprintrecognition_paddlepaddle_torch.infer_utils import der as tder
from voiceprintrecognition_paddlepaddle_torch.infer_utils.speaker_diarization \
    import SpeakerDiarization, SpectralCluster, kmeans
from voiceprintrecognition_paddlepaddle_torch.ops.audio import AudioSegment
from voiceprintrecognition_paddlepaddle_torch.predict import Predictor
from voiceprintrecognition_paddlepaddle_tpu.infer_utils import der as jder
from voiceprintrecognition_paddlepaddle_tpu.infer_utils.speaker_diarization \
    import SpeakerDiarization as JaxSpeakerDiarization
from voiceprintrecognition_paddlepaddle_tpu.infer_utils.speaker_diarization \
    import SpectralCluster as JaxSpectralCluster
from voiceprintrecognition_paddlepaddle_tpu.ops.audio import \
    AudioSegment as JaxAudioSegment
from voiceprintrecognition_paddlepaddle_tpu.ops.features import \
    compute_feature
from voiceprintrecognition_paddlepaddle_tpu.predict import \
    Predictor as JaxPredictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000


def _scene():
    """12 s: a 150 Hz tone speaker 0-5 s, 1 s of silence, a noise speaker
    6-12 s."""
    noise = (np.random.RandomState(0).randn(6 * SR) * 0.1).astype(np.float32)
    return np.concatenate([tone(150, 5.0, 1), np.zeros(SR, np.float32),
                           noise])


def _blobs(n_blobs, seed, per=30, dim=16):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.randn(per, dim) * 0.05 + np.eye(dim)[i]
                           for i in range(n_blobs)])


def _same_partition(a, b):
    a, b = np.asarray(a), np.asarray(b)
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def _configs():
    with open(os.path.join(ROOT, "configs", "cam++.yml"), encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    return {k: cfg[k] for k in ("dataset_conf", "preprocess_conf",
                                "model_conf")}


def _save(root, variables, tmodel):
    torch.save(tmodel.state_dict(), str(root / "model.pt"))
    (root / "model.msgpack").write_bytes(
        serialization.msgpack_serialize(variables))
    return str(root / "model.pt"), str(root / "model.msgpack")


@pytest.fixture(scope="module")
def stock(tmp_path_factory):
    """The stock CAM++ (``configs/cam++.yml``) with seeded weights."""
    jm, v, tm = synth_campplus(FULL, seed=3)
    pt, _ = _save(tmp_path_factory.mktemp("stock"), v, tm)
    return jm, v, pt


@pytest.fixture(scope="module")
def calibrated(tmp_path_factory):
    """The stock model with its BN statistics calibrated on tone and noise
    clips, in both layouts: its embeddings tell the scene's two speakers
    apart."""
    _, v, tm = synth_campplus(FULL, seed=3)
    v, tm = calibrate_bn_stats(v, tm, calibration_clips())
    return _save(tmp_path_factory.mktemp("calibrated"), v, tm)


def _capture_features(sd):
    """Wrap ``sd.clustering`` to record the embedding matrix it gets."""
    seen = []
    real = sd.clustering

    def spy(features, speaker_num=None):
        seen.append(features)
        return real(features, speaker_num=speaker_num)

    sd.clustering = spy
    return seen


def test_segments_and_chunks_match_jax():
    scene = _scene()
    ours = SpeakerDiarization().segments_audio(AudioSegment(scene, SR))
    theirs = JaxSpeakerDiarization().segments_audio(
        JaxAudioSegment(scene, SR))
    assert len(ours) == len(theirs) > 8
    for (s, e, c), (js, je, jc) in zip(ours, theirs):
        assert (s, e) == (js, je)
        assert c.shape == (24000,)
        np.testing.assert_array_equal(c, jc)
    data = np.arange(SR * 4, dtype=np.float32)
    segs = [[2.0, 6.0, data], [7.0, 7.4, data[:6400]]]
    for a, b in zip(SpeakerDiarization()._chunk(segs),
                    JaxSpeakerDiarization()._chunk(segs)):
        assert a[:2] == b[:2]
        np.testing.assert_array_equal(a[2], b[2])


def test_short_speech_raises():
    with pytest.raises(ValueError, match="too short"):
        SpeakerDiarization()._check_audio_list(
            [[0.0, 1.0, np.zeros(SR, np.float32)]])


@pytest.mark.parametrize("n_blobs", [2, 3, 5])
def test_spectral_stages_match_jax(n_blobs):
    X = _blobs(n_blobs, seed=n_blobs)
    ours, theirs = SpectralCluster(), JaxSpectralCluster()
    sim, jsim = ours.get_sim_mat(X), theirs.get_sim_mat(X)
    np.testing.assert_allclose(sim, jsim, rtol=1e-6)
    pruned, jpruned = ours.p_pruning(sim), theirs.p_pruning(jsim)
    np.testing.assert_allclose(pruned, jpruned, rtol=1e-6)
    lap = ours.get_laplacian(0.5 * (pruned + pruned.T))
    jlap = theirs.get_laplacian(0.5 * (jpruned + jpruned.T))
    np.testing.assert_allclose(lap, jlap, rtol=1e-6)
    np.testing.assert_allclose(np.linalg.eigvalsh(lap),
                               np.linalg.eigvalsh(jlap), rtol=1e-6,
                               atol=1e-12)
    (emb, k), (jemb, jk) = ours.get_spec_embs(lap), theirs.get_spec_embs(jlap)
    assert k == jk == n_blobs
    assert emb.shape == jemb.shape


@pytest.mark.parametrize("oracle", [False, True])
@pytest.mark.parametrize("n_blobs", [2, 3, 5])
def test_kmeans_partition_matches_jax(n_blobs, oracle):
    X = _blobs(n_blobs, seed=10 + n_blobs)
    num = n_blobs if oracle else None
    ours = SpectralCluster()(X, oracle_num=num)
    theirs = JaxSpectralCluster()(X, oracle_num=num)
    assert len(set(ours.tolist())) == n_blobs
    assert _same_partition(ours, theirs)
    # k-means alone on the raw blobs, against scikit-learn's
    raw = kmeans(X, n_blobs, np.random.default_rng(0))
    assert _same_partition(raw, JaxSpectralCluster.cluster_embs(X, n_blobs))


def test_kmeans_is_deterministic_per_seed():
    X = np.random.RandomState(0).rand(200, 4)   # no clear clusters
    a = SpectralCluster(seed=7).cluster_embs(X, 5)
    b = SpectralCluster(seed=7).cluster_embs(X, 5)
    np.testing.assert_array_equal(a, b)
    runs = {tuple(kmeans(X, 5, np.random.default_rng(s)).tolist())
            for s in range(6)}
    assert len(runs) > 1            # the seed, not chance, fixes the result
    assert set(kmeans(X, 1, np.random.default_rng(0)).tolist()) == {0}
    # fewer distinct points than clusters: the labels come from the final
    # centres, so equal points share a label and fewer than k clusters are
    # left, as scikit-learn leaves them
    dup = np.array([[0.0, 0.0]] * 5 + [[1.0, 1.0]])
    for s in range(3):
        got = kmeans(dup, 3, np.random.default_rng(s))
        assert _same_partition(got, [0, 0, 0, 0, 0, 1])
    with pytest.warns(Warning, match="distinct clusters"):
        want = JaxSpectralCluster.cluster_embs(dup, 3)
    assert _same_partition(got, want)
    with pytest.raises(ValueError, match="k-means"):
        kmeans(X[:3], 4, np.random.default_rng(0))


def test_merge_clustering_and_postprocess_exact():
    labels = np.array([0, 1, 2, 0, 1, 2])
    centers = np.array([[1.0, 0.0], [0.99, 0.05], [0.0, 1.0]])
    for thr in (0.9, 0.999, 1.0):
        np.testing.assert_array_equal(
            SpeakerDiarization._merge_by_cos(labels, centers, thr),
            JaxSpeakerDiarization._merge_by_cos(labels, centers, thr))
    rng = np.random.RandomState(0)
    base = np.eye(16)
    X = np.concatenate([rng.randn(30, 16) * 0.02 + base[0],
                        rng.randn(30, 16) * 0.02
                        + (0.995 * base[0] + 0.1 * base[1]),
                        rng.randn(30, 16) * 0.02 + base[5]])
    for num in (None, 3):
        ours = SpeakerDiarization(merge_threshold=0.9).clustering(X, num)
        theirs = JaxSpeakerDiarization(merge_threshold=0.9).clustering(X, num)
        np.testing.assert_array_equal(ours[0], theirs[0])
        np.testing.assert_array_equal(ours[1], theirs[1])
    segments = [[0.0, 1.5, None], [0.75, 2.25, None], [2.2, 3.7, None],
                [3.6, 5.1, None], [4.35, 5.85, None], [5.1, 6.6, None],
                [9.0, 10.5, None]]
    for lab in ([0, 0, 1, 1, 0, 1, 1], [0, 1, 0, 1, 0, 1, 0],
                [2, 2, 2, 1, 0, 0, 1]):
        assert SpeakerDiarization().postprocess(segments, np.array(lab)) == \
            JaxSpeakerDiarization().postprocess(segments, np.array(lab))


def test_chunk_embeddings_match_jax_exact_length(stock):
    jm, v, pt = stock
    pred = Predictor(_configs(), model_path=pt, device="cpu")
    assert pred._embed is not None                  # the kernel path
    seen = _capture_features(pred.speaker_diarize)
    scene = _scene()
    out = pred.speaker_diarization(scene, sample_rate=SR)
    assert out and all(o["end"] > o["start"] for o in out)
    segs = JaxSpeakerDiarization().segments_audio(
        JaxAudioSegment(scene, SR).normalize(target_db=-20))
    feats = compute_feature(np.stack([s[2] for s in segs]), "Fbank",
                            sr=SR, n_mels=80)
    exact = np.asarray(jax.jit(lambda x: jm.apply(v, x, train=False))(feats))
    got = seen[0]
    assert got.shape == exact.shape == (len(segs), 192)
    for i in range(len(segs)):
        assert cos_min(exact[i:i + 1], got[i:i + 1]) > 0.999, i


def test_whole_run_matches_the_jax_pipeline(calibrated):
    pt, msgpack = calibrated
    cfg = _configs()
    scene = _scene()
    pred = Predictor(cfg, model_path=pt, device="cpu")
    seen = _capture_features(pred.speaker_diarize)
    jpred = JaxPredictor(cfg, model_path=msgpack, use_gpu=False)
    jseen = _capture_features(jpred.speaker_diarize)
    for num in (None, 2):
        out = pred.speaker_diarization(scene, sample_rate=SR, speaker_num=num)
        jout = jpred.speaker_diarization(scene, sample_rate=SR,
                                         speaker_num=num)
        # the scene is one where the JAX pipeline labels the port's
        # embeddings as it labels its own
        jsd = JaxSpeakerDiarization()
        assert _same_partition(jsd.clustering(seen[-1], num)[0],
                               jsd.clustering(jseen[-1], num)[0])
        assert len({o["speaker"] for o in out}) == 2
        assert len(out) == len(jout)
        relabel = {}
        for o, j in zip(out, jout):
            assert relabel.setdefault(o["speaker"], j["speaker"]) == \
                j["speaker"]
            assert abs(o["start"] - j["start"]) <= 0.01
            assert abs(o["end"] - j["end"]) <= 0.01
        assert len(set(relabel.values())) == len(relabel)


def test_der_and_rttm_match_jax(tmp_path):
    rng = np.random.RandomState(3)

    def segs(n, names):
        t = np.cumsum(rng.uniform(0.2, 2.0, 2 * n))
        return [(float(t[2 * i]), float(t[2 * i + 1]), names[rng.randint(
            len(names))]) for i in range(n)]

    for _ in range(5):
        ref, hyp = segs(12, ["A", "B", "C"]), segs(10, ["x", "y"])
        ours = tder.diarization_error_rate(ref, hyp, detailed=True)
        theirs = jder.diarization_error_rate(ref, hyp, detailed=True)
        assert ours.keys() == theirs.keys()
        for k in ours:
            assert abs(ours[k] - theirs[k]) <= 1e-9, k
    out = [{"speaker": s, "start": a, "end": b} for a, b, s in ref]
    f1, f2 = io.StringIO(), io.StringIO()
    tder.write_rttm(f1, "meeting", out)
    jder.write_rttm(f2, "meeting", out)
    assert f1.getvalue() == f2.getvalue()
    path = tmp_path / "hyp.rttm"
    path.write_text(f1.getvalue(), encoding="utf-8")
    assert tder.load_rttm(str(path)) == jder.load_rttm(str(path))
