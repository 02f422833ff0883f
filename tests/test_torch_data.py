"""PyTorch port, the data pipeline against the JAX package's host code
(copied, so bit for bit): the metrics, ``SpeakerDataset`` items in its
train mode (with speed perturbation, per item and through the native
batch loader), eval mode and ``.npy`` lists for the same seed and list,
``BatchSampler`` / ``PKSampler`` batches per epoch, ``collate_waveforms``
/ ``collate_features``, ``load_batch_native`` and the in-order
``DataLoader``."""

import numpy as np
import pytest

from torch_jax_native import require_jax_native
from voiceprintrecognition_paddlepaddle_torch import data_utils as tdata
from voiceprintrecognition_paddlepaddle_torch.metric import metrics as tm
from voiceprintrecognition_paddlepaddle_torch.native import \
    load_batch_native
from voiceprintrecognition_paddlepaddle_tpu import data_utils as jdata
from voiceprintrecognition_paddlepaddle_tpu.data_utils import \
    pk_sampler as jpk
from voiceprintrecognition_paddlepaddle_tpu.metric import metrics as jm
from voiceprintrecognition_paddlepaddle_tpu.native import \
    load_batch_native as jax_load_batch_native

from test_torch_helpers import speaker_corpus
from torch_card import write_wav


def _same(a, b):
    assert type(a) is type(b) or (isinstance(a, (int, np.integer))
                                  and isinstance(b, (int, np.integer)))
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_are_bit_identical(seed):
    rng = np.random.RandomState(seed)
    scores = rng.randn(500).astype(np.float32)
    labels = (rng.rand(500) < 0.2).astype(np.int32)
    scores[labels == 1] += 1.0
    ref = jm.compute_fnr_fpr(scores, labels)
    got = tm.compute_fnr_fpr(scores, labels)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    assert tm.compute_eer(got[0], got[1], scores) == \
        jm.compute_eer(ref[0], ref[1], scores)
    assert tm.compute_dcf(got[0], got[1]) == jm.compute_dcf(ref[0], ref[1])
    with pytest.raises(ValueError, match="undefined"):
        tm.compute_fnr_fpr(scores, np.zeros_like(labels))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    lists = speaker_corpus(root, n_speakers=4, n_utts=6, seconds=(0.6, 2.0))
    # a clip shorter than min_duration: both skip to the next item
    write_wav(root / "wavs" / "short.wav", np.zeros(2000))
    with open(lists[0], "a", encoding="utf-8") as f:
        f.write(f"{root / 'wavs' / 'short.wav'}\t1\n")
    # a 44.1 kHz clip: resampled on load
    rng = np.random.RandomState(9)
    write_wav(root / "wavs" / "hi.wav", rng.randn(44100) * 0.1, sr=44100)
    with open(lists[0], "a", encoding="utf-8") as f:
        f.write(f"{root / 'wavs' / 'hi.wav'}\t2\n")
    npy = root / "npy"
    npy.mkdir()
    lines = []
    for i in range(6):
        p = npy / f"f{i}.npy"
        np.save(p, rng.randn(int(rng.uniform(50, 200)), 8).astype(np.float32))
        lines.append(f"{p}\t{i % 3}")
    (root / "npy.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")
    return lists, str(root / "npy.txt")


AUG = {"speed": {"prob": 0.7, "speed_perturb_3_class": True}}


@pytest.mark.parametrize("mode,aug", [("train", AUG), ("train", None),
                                      ("eval", None)])
def test_dataset_items_are_bit_identical(corpus, mode, aug):
    require_jax_native()
    lists, _ = corpus
    kw = dict(data_list_path=lists[0], mode=mode, aug_conf=aug,
              num_speakers=4, max_duration=1.0, min_duration=0.3, seed=11)
    tds, jds = tdata.SpeakerDataset(**kw), jdata.SpeakerDataset(**kw)
    assert tds.lines == jds.lines and len(tds) == len(jds)
    for i in list(range(len(tds))) * 2:
        _same(tds[i], jds[i])


def test_native_train_batches_are_bit_identical(corpus):
    require_jax_native()
    lists, _ = corpus
    kw = dict(data_list_path=lists[0], mode="train", aug_conf=AUG,
              num_speakers=4, max_duration=1.0, min_duration=0.3, seed=5)
    tds, jds = tdata.SpeakerDataset(**kw), jdata.SpeakerDataset(**kw)
    order = np.random.RandomState(0).permutation(len(tds))
    for chunk in np.array_split(order, 4):
        got = tds.load_batch(list(chunk), n_threads=2)
        ref = jds.load_batch(list(chunk), n_threads=2)
        assert got is not None and ref is not None
        _same(tuple(got), tuple(ref))
    assert tdata.SpeakerDataset(
        data_list_path=lists[1], mode="eval").load_batch([0]) is None


def test_npy_lists_are_bit_identical(corpus):
    _, npy = corpus
    for mode in ("train", "eval"):
        kw = dict(data_list_path=npy, mode=mode, max_feature_len=100, seed=3)
        tds, jds = tdata.SpeakerDataset(**kw), jdata.SpeakerDataset(**kw)
        for i in list(range(len(tds))) * 2:
            _same(tds[i], jds[i])
        assert tds.load_batch([0]) is None


def test_load_batch_native_is_bit_identical(corpus):
    require_jax_native()
    lists, _ = corpus
    paths = [ln.split("\t")[0] for ln in open(lists[0], encoding="utf-8")
             if ln.strip()]
    rng = np.random.RandomState(1)
    speeds = [[(1, 1), (9, 10), (11, 10)][k] for k in rng.randint(0, 3,
                                                                 len(paths))]
    fracs = rng.rand(len(paths)).astype(np.float32)
    got = load_batch_native(paths, 16000, 16000, speeds, fracs, 3)
    ref = jax_load_batch_native(paths, 16000, 16000, speeds, fracs, 3)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    got = load_batch_native(paths[:3] + ["/nonexistent.wav"], 16000, 8000)
    assert got[1][3] < 0 and (got[1][:3] > 0).all()


class _Labels:
    def __init__(self, labels):
        self.labels = labels

    def __len__(self):
        return len(self.labels)


@pytest.mark.parametrize("kw", [
    dict(batch_size=4), dict(batch_size=3, shuffle=False),
    dict(batch_size=5, drop_last=False),
    dict(batch_size=4, num_replicas=2, rank=1),
    dict(batch_size=4, drop_last=False, num_replicas=3, rank=2)])
def test_batch_sampler_is_identical(kw):
    ds = _Labels(list(range(23)))
    ts, js = tdata.BatchSampler(ds, **kw), jpk.BatchSampler(ds, **kw)
    assert len(ts) == len(js)
    for epoch in range(3):
        ts.set_epoch(epoch)
        js.set_epoch(epoch)
        assert list(ts) == list(js)


@pytest.mark.parametrize("kw", [dict(batch_size=8, sample_per_id=4),
                                dict(batch_size=6, sample_per_id=2,
                                     num_replicas=2, rank=1)])
def test_pk_sampler_is_identical(kw):
    ds = _Labels([i % 7 for i in range(60)])
    ts, js = tdata.PKSampler(ds, **kw), jdata.PKSampler(ds, **kw)
    assert len(ts) == len(js)
    for epoch in range(3):
        ts.set_epoch(epoch)
        js.set_epoch(epoch)
        got, ref = list(ts), list(js)
        assert got == ref and len(got) == len(ts)


@pytest.mark.parametrize("bucket,int16", [(True, False), (False, True),
                                          (True, True)])
def test_collate_waveforms_is_identical(bucket, int16):
    rng = np.random.RandomState(2)
    items = [(rng.uniform(-1.2, 1.2, n).astype(np.float32), i, n)
             for i, n in enumerate((1000, 17000, 33000))]
    items.append((rng.randint(-3000, 3000, 500).astype(np.int16), 7, 500))
    _same(tdata.collate_waveforms(items, bucket=bucket, quantize_int16=int16),
          jdata.collate_waveforms(items, bucket=bucket, quantize_int16=int16))


@pytest.mark.parametrize("bucket", [True, False])
def test_collate_features_is_identical(bucket):
    rng = np.random.RandomState(3)
    items = [(rng.randn(t, 8).astype(np.float32), i, t)
             for i, t in enumerate((50, 129, 300))]
    _same(tdata.collate_features(items, bucket=bucket),
          jdata.collate_features(items, bucket=bucket))


def test_data_loader_keeps_the_sampler_order():
    class DS:
        def __getitem__(self, i):
            return (np.full(3, i, np.float32), i, 3)

    sampler = [[5, 1], [0, 2], [4, 3], [7, 6]]
    ref = [b for b in sampler]
    for workers in (1, 3):
        loader = tdata.DataLoader(DS(), sampler, lambda items: [
            int(x[1]) for x in items], num_workers=workers)
        assert len(loader) == 4 and list(loader) == ref
