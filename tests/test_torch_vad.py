"""PyTorch port, host audio transforms: the port's copies of ``vad``
(spectral and energy), ``crop`` and ``pad_silence`` give the JAX
package's results. Bars: the same segment lists (exact floats), the same
samples."""

import os

import numpy as np
import pytest

import torch_jax_native  # noqa: F401 (JAX's native library, locked)
from test_vad_noisy import SR, _babble, _voice
from voiceprintrecognition_paddlepaddle_torch.ops.audio import AudioSegment
from voiceprintrecognition_paddlepaddle_tpu.ops.audio import \
    AudioSegment as JaxAudioSegment

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def noisy_scene():
    """The scene of ``tests/test_vad_noisy.py``: two harmonic speakers
    alternating 3 s utterances over a babble bed at 8 dB SNR."""
    rng = np.random.RandomState(0)
    utt, gap = 3.0, 1.5
    speakers = [0, 1, 0, 1, 0, 1]
    n = int((gap + len(speakers) * (utt + gap)) * SR)
    sig = np.zeros(n)
    cursor = gap
    for spk in speakers:
        a, b = int(cursor * SR), int((cursor + utt) * SR)
        v = _voice((125.0, 290.0)[spk], np.arange(b - a) / SR, rng)
        sig[a:b] += v / np.std(v)
        cursor += utt + gap
    noise = _babble(n, rng) * (10 ** (-8.0 / 20.0))
    return ((sig + noise) * 0.1).astype(np.float32)


def _both(samples, sr=SR):
    return AudioSegment(samples.copy(), sr), JaxAudioSegment(samples.copy(), sr)


@pytest.mark.parametrize("method", ["spectral", "energy"])
def test_vad_matches_jax_on_test_long(method):
    path = os.path.join(ROOT, "dataset", "test_long.wav")
    ours, theirs = AudioSegment.from_file(path), JaxAudioSegment.from_file(path)
    got = ours.vad(method=method)
    assert got and got == theirs.vad(method=method)
    assert ours.vad(method=method, return_seconds=False) == \
        theirs.vad(method=method, return_seconds=False)


@pytest.mark.parametrize("method", ["spectral", "energy"])
def test_vad_matches_jax_on_the_noisy_scene(noisy_scene, method):
    ours, theirs = _both(noisy_scene)
    assert ours.vad(method=method) == theirs.vad(method=method)


@pytest.mark.parametrize("method", ["spectral", "energy"])
@pytest.mark.parametrize("n", [0, 100, 3 * SR])
def test_vad_on_silence_and_empty_clips(method, n):
    ours, theirs = _both(np.zeros(n, np.float32))
    assert ours.vad(method=method) == theirs.vad(method=method) == []


def test_vad_rejects_unknown_method():
    with pytest.raises(ValueError, match="unknown VAD method"):
        AudioSegment(np.zeros(SR, np.float32), SR).vad(method="webrtc")


def test_crop_and_pad_silence_match_jax():
    x = (np.random.RandomState(4).randn(2 * SR) * 0.1).astype(np.float32)
    for dur in (0.5, 1.25, 3.0):
        ours, theirs = _both(x)
        np.testing.assert_array_equal(ours.crop(dur).samples,
                                      theirs.crop(dur).samples)
    for sides in ("beginning", "end", "both"):
        ours, theirs = _both(x)
        np.testing.assert_array_equal(ours.pad_silence(0.3, sides).samples,
                                      theirs.pad_silence(0.3, sides).samples)
    ours = AudioSegment(x.copy(), SR).crop(1.0, mode="train")
    assert ours.num_samples == SR
