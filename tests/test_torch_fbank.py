"""PyTorch port, fbank front end: the plain torch fbank and the fused
kernel's plain version against the JAX ``kaldi.fbank`` and the Pallas
kernel (interpret mode), and the CMN'd features against
``compute_feature``. The CUDA kernel itself is held against its plain
version in ``test_torch_gpu.py``.

Bars (``tests/test_pallas_fbank.py:23-25``): max |d| < 2e-2 and 99th
percentile < 1e-3 on raw log-mel; < 2e-3 on the CMN'd features.
"""

import numpy as np
import pytest
import torch

from voiceprintrecognition_paddlepaddle_torch.ops import features as tfeat
from voiceprintrecognition_paddlepaddle_torch.ops import kaldi as tkaldi
from voiceprintrecognition_paddlepaddle_torch.ops.fbank_kernel import (
    fbank_fused, fbank_fused_reference, folded_dft_np)
from voiceprintrecognition_paddlepaddle_tpu.ops import features as jfeat
from voiceprintrecognition_paddlepaddle_tpu.ops import kaldi as jkaldi
from voiceprintrecognition_paddlepaddle_tpu.ops.pallas_fbank import (
    _folded_dft_np, fbank_pallas)


def _waves(seed, b, n):
    return (np.random.RandomState(seed).randn(b, n) * 0.1).astype(np.float32)


def _assert_fbank_bar(got, ref):
    assert got.shape == ref.shape
    d = np.abs(got - ref)
    assert d.max() < 2e-2
    assert np.percentile(d, 99) < 1e-3


@pytest.mark.parametrize("n_mels", [80, 40])
def test_plain_fbank_matches_jax_kaldi(n_mels):
    w = _waves(0, 3, 16000)
    ref = np.asarray(jkaldi.fbank(w, sr=16000, n_mels=n_mels))
    got = tkaldi.fbank(torch.from_numpy(w), sr=16000, n_mels=n_mels).numpy()
    _assert_fbank_bar(got, ref)


@pytest.mark.parametrize("n_samples", [16000, 8000, 48000 + 123])
def test_fused_reference_matches_jax_kaldi(n_samples):
    w = _waves(1, 2, n_samples)
    ref = np.asarray(jkaldi.fbank(w, sr=16000, n_mels=80))
    got = fbank_fused_reference(torch.from_numpy(w), n_mels=80).numpy()
    _assert_fbank_bar(got, ref)


def test_fused_reference_matches_pallas_interpret():
    w = _waves(2, 2, 16000)
    ref = np.asarray(fbank_pallas(w, sr=16000, n_mels=80, interpret=True))
    got = fbank_fused_reference(torch.from_numpy(w), n_mels=80).numpy()
    _assert_fbank_bar(got, ref)


def test_folded_dft_is_the_jax_table():
    np.testing.assert_array_equal(folded_dft_np(400, 512),
                                  _folded_dft_np(400, 512))


def test_cmn_features_match_compute_feature():
    w = _waves(3, 4, 32000)
    ratios = np.asarray([1.0, 0.31, 0.5, 0.77], np.float32)
    ref = np.asarray(jfeat.compute_feature(w, "Fbank", sr=16000, n_mels=80,
                                           input_lens_ratio=ratios))
    got = tfeat.compute_feature(torch.from_numpy(w), "Fbank", sr=16000,
                                n_mels=80, input_lens_ratio=ratios).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 2e-3
    # exact-length CMN (no ratios) through the featurizer object
    feat = tfeat.AudioFeaturizer("Fbank", {"sr": 16000, "n_mels": 80})
    ref_u = np.asarray(jfeat.compute_feature(w, "Fbank", sr=16000, n_mels=80))
    assert np.abs(feat(w).numpy() - ref_u).max() < 2e-3


def test_apply_cmn_and_mask_matches_jax():
    rng = np.random.RandomState(4)
    raw = rng.randn(3, 97, 80).astype(np.float32)
    ratios = np.asarray([1.0, 0.5, 0.013], np.float32)   # last: 1 frame
    for r in (None, ratios):
        ref = np.asarray(jfeat.apply_cmn_and_mask(raw, r))
        got = tfeat.apply_cmn_and_mask(torch.from_numpy(raw), r).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", [400, 401, 16000, 56000, 128000])
def test_frame_counts_match_jax(n):
    tf = tfeat.AudioFeaturizer("Fbank", {"sr": 16000, "n_mels": 80})
    jf = jfeat.AudioFeaturizer("Fbank", {"sr": 16000, "n_mels": 80})
    assert tf.num_frames(n) == jf.num_frames(n)
    assert tkaldi.num_frames_kaldi(n, 400, 160, False) == \
        jkaldi.num_frames_kaldi(n, 400, 160, False)
    assert tf.feature_dim == jf.feature_dim == 80


@pytest.mark.parametrize("bad", [dict(dither=1.0), dict(snip_edges=False),
                                 dict(window_type="hamming"),
                                 dict(use_energy=True)])
def test_non_stock_options_raise(bad):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tfeat.AudioFeaturizer("Fbank", {"n_mels": 80, **bad})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tkaldi.fbank(torch.zeros(1, 1600), n_mels=80, **bad)


def test_other_feature_methods_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tfeat.AudioFeaturizer("MelSpectrogram", {})


def test_cpu_tensor_runs_plain_version_without_launch():
    w = torch.from_numpy(_waves(5, 2, 16000))
    before = fbank_fused.launches
    got = fbank_fused(w, n_mels=80)
    assert fbank_fused.launches == before
    torch.testing.assert_close(got, fbank_fused_reference(w, n_mels=80),
                               rtol=0, atol=0)

