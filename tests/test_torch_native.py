"""PyTorch port, native audio I/O: the port's copy of ``audioio.cpp``,
built by its own binding under ``build/native/``, decodes and resamples
exactly as the JAX package's library does (same source, same g++ flags),
and ``AudioSegment`` reaches it in the same order: native decode first,
the Python decoders for a file it does not read, always the native
resampler. Bars: equality, bit for bit."""

import glob
import io
import os
import struct
import subprocess
import wave

import numpy as np
import pytest

from torch_jax_native import require_jax_native
from voiceprintrecognition_paddlepaddle_torch.native import audio_native
from voiceprintrecognition_paddlepaddle_torch.native import (
    decode_wav_native, native_library, resample_native, rms_db_native)
from voiceprintrecognition_paddlepaddle_torch.ops import audio as taudio
from voiceprintrecognition_paddlepaddle_torch.ops.audio import AudioSegment
from voiceprintrecognition_paddlepaddle_tpu import native as jnative
from voiceprintrecognition_paddlepaddle_tpu.ops.audio import \
    AudioSegment as JaxAudioSegment

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "voiceprintrecognition_paddlepaddle_torch")
DEMO_WAVS = sorted(glob.glob(os.path.join(ROOT, "dataset", "*.wav")))


def _pcm_wav(frames, width, rate, channels=1):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(frames.tobytes())
    return buf.getvalue()


def _float_wav(samples, rate, channels=1):
    bits = samples.dtype.itemsize * 8
    payload = samples.tobytes()
    block = channels * samples.dtype.itemsize
    return (b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 3, channels, rate,
                                    rate * block, block, bits)
            + b"data" + struct.pack("<I", len(payload)) + payload)


def _synth(kind):
    rng = np.random.RandomState(0)
    x = rng.randn(4003) * 0.3
    if kind == "int16":
        return _pcm_wav((np.clip(x, -1, 1) * 32767).astype("<i2"), 2, 16000)
    if kind == "uint8":
        return _pcm_wav((np.clip(x, -1, 1) * 127 + 128).astype(np.uint8), 1,
                        8000)
    if kind == "int32":
        return _pcm_wav((np.clip(x, -1, 1) * (2 ** 31 - 1)).astype("<i4"), 4,
                        22050)
    if kind == "stereo_int16":
        st = (np.clip(rng.randn(4003, 2) * 0.3, -1, 1) * 32767).astype("<i2")
        return _pcm_wav(st, 2, 44100, channels=2)
    if kind == "float32":
        return _float_wav(x.astype("<f4"), 48000)
    if kind == "float64_stereo":
        return _float_wav(rng.randn(4003, 2).astype("<f8") * 0.3, 16000,
                          channels=2)
    raise ValueError(kind)


SYNTH = ["int16", "uint8", "int32", "stereo_int16", "float32",
         "float64_stereo"]


@pytest.mark.parametrize("case", [os.path.basename(p) for p in DEMO_WAVS]
                         + SYNTH)
def test_decode_matches_jax_bit_for_bit(case):
    require_jax_native()
    if case in SYNTH:
        data = _synth(case)
    else:
        with open(os.path.join(ROOT, "dataset", case), "rb") as f:
            data = f.read()
    ours, theirs = decode_wav_native(data), jnative.decode_wav_native(data)
    assert ours is not None and theirs is not None
    assert ours[1] == theirs[1]
    assert ours[0].dtype == np.float32
    np.testing.assert_array_equal(ours[0], theirs[0])


def test_audio_segment_from_file_and_bytes_match_jax():
    require_jax_native()
    for path in DEMO_WAVS:
        ours, theirs = AudioSegment.from_file(path), JaxAudioSegment.from_file(path)
        np.testing.assert_array_equal(ours.samples, theirs.samples)
        assert ours.sample_rate == theirs.sample_rate
        with open(path, "rb") as f:
            data = f.read()
        np.testing.assert_array_equal(AudioSegment.from_bytes(data).samples,
                                      ours.samples)


@pytest.mark.parametrize("sr_in", [44100, 8000, 48000])
def test_resample_matches_jax_bit_for_bit(sr_in):
    """The port's resampler was scipy's ``resample_poly``: on seeded noise
    it differed from the JAX native filter by up to 0.027 at 44.1 kHz."""
    require_jax_native()
    x = (np.random.RandomState(sr_in).randn(sr_in) * 0.1).astype(np.float32)
    ours = resample_native(x, sr_in, 16000)
    theirs = jnative.resample_native(x, sr_in, 16000)
    np.testing.assert_array_equal(ours, theirs)
    seg = AudioSegment(x.copy(), sr_in).resample(16000)
    jseg = JaxAudioSegment(x.copy(), sr_in).resample(16000)
    assert seg.sample_rate == jseg.sample_rate == 16000
    np.testing.assert_array_equal(seg.samples, jseg.samples)


def test_rms_db_matches_jax():
    require_jax_native()
    x = (np.random.RandomState(2).randn(5000) * 0.2).astype(np.float32)
    assert rms_db_native(x) == jnative.rms_db_native(x)
    assert rms_db_native(np.zeros(10, np.float32)) == -100.0


def test_resample_of_empty_clip_is_empty():
    out = resample_native(np.zeros((0,), np.float32), 8000, 16000)
    assert out.shape == (0,) and out.dtype == np.float32


def test_library_builds_under_build_not_in_the_package():
    path = native_library()._name
    assert os.path.commonpath([path, os.path.join(ROOT, "build", "native")]) \
        == os.path.join(ROOT, "build", "native")
    assert os.path.exists(path)
    assert not glob.glob(os.path.join(PKG, "**", "*.so"), recursive=True)


def test_failed_build_raises_with_the_compiler_message(monkeypatch, tmp_path):
    monkeypatch.setattr(audio_native, "_lib", None)
    monkeypatch.setattr(audio_native, "_BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(audio_native.subprocess, "run",
                        lambda *a, **k: subprocess.CompletedProcess(
                            a[0], 1, "", "audioio.cpp:1: error: boom"))
    with pytest.raises(RuntimeError, match="error: boom"):
        native_library()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        AudioSegment(np.zeros(800, np.float32), 8000).resample(16000)


def test_undecodable_file_goes_to_the_python_decoders(monkeypatch, tmp_path):
    """A file the native decoder refuses (error code not 0) is read by the
    stdlib / numpy decoders, as in the JAX package."""
    data = _synth("int16")
    path = tmp_path / "x.wav"
    path.write_bytes(data)
    monkeypatch.setattr(taudio, "decode_wav_native", lambda _: None)
    with wave.open(io.BytesIO(data)) as w:
        raw = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    want = raw.astype(np.float32) / 32768.0
    np.testing.assert_array_equal(AudioSegment.from_bytes(data).samples, want)
    np.testing.assert_array_equal(AudioSegment.from_file(str(path)).samples,
                                  want)
    f32 = _synth("float32")
    np.testing.assert_array_equal(
        AudioSegment.from_bytes(f32).samples,
        JaxAudioSegment.from_bytes(f32).samples)
    with pytest.raises(ValueError, match="RIFF"):
        AudioSegment.from_bytes(b"not a wav")
