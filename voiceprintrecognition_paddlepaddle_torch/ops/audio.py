"""Host-side audio container: decode / resample / normalize / write.

Copy of the decode, resample and dB-normalisation parts of the JAX
package's ``ops/audio.py`` (numpy, scipy and the stdlib ``wave`` only).
WAV decode is stdlib + numpy; resampling is polyphase via scipy."""

import io
import struct
import wave

import numpy as np
from scipy.signal import resample_poly

__all__ = ["AudioSegment"]


def _decode_wav(fobj):
    """Decode a WAV file object to (float32 mono samples, rate)."""
    with wave.open(fobj, "rb") as w:
        channels = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        ints = (b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        data = ints.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return np.ascontiguousarray(data), rate


def _decode_ieee_float_wav(path_or_bytes):
    """RIFF parser for IEEE-float WAVs the stdlib rejects."""
    if isinstance(path_or_bytes, bytes):
        buf = path_or_bytes
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    if buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos, fmt, data = 12, None, None
    while pos + 8 <= len(buf):
        cid, size = buf[pos:pos + 4], struct.unpack("<I", buf[pos + 4:pos + 8])[0]
        body = buf[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError("missing fmt/data chunk")
    audio_fmt, channels, rate, _, _, bits = fmt
    if audio_fmt == 3 and bits == 32:
        samples = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif audio_fmt == 3 and bits == 64:
        samples = np.frombuffer(data, dtype="<f8").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format code {audio_fmt}/{bits}bit")
    if channels > 1:
        samples = samples.reshape(-1, channels).mean(axis=1)
    return np.ascontiguousarray(samples), rate


class AudioSegment:
    """Mono float32 waveform with a sample rate."""

    def __init__(self, samples, sample_rate):
        samples = np.asarray(samples, dtype=np.float32)
        if samples.ndim == 2:
            samples = samples.mean(axis=1)
        self._samples = np.ascontiguousarray(samples)
        self._sample_rate = int(sample_rate)

    @classmethod
    def from_file(cls, file):
        if hasattr(file, "read"):
            return cls.from_bytes(file.read())
        try:
            samples, rate = _decode_wav(str(file))
        except (wave.Error, EOFError):
            samples, rate = _decode_ieee_float_wav(str(file))
        return cls(samples, rate)

    @classmethod
    def from_bytes(cls, data: bytes):
        try:
            samples, rate = _decode_wav(io.BytesIO(data))
        except (wave.Error, EOFError):
            samples, rate = _decode_ieee_float_wav(data)
        return cls(samples, rate)

    @classmethod
    def from_ndarray(cls, data, samplerate=16000):
        data = np.asarray(data)
        if data.dtype.kind == "i":
            scale = float(np.iinfo(data.dtype).max) + 1.0
            data = data.astype(np.float32) / scale
        return cls(data, samplerate)

    @property
    def samples(self):
        return self._samples

    @property
    def sample_rate(self):
        return self._sample_rate

    @property
    def duration(self):
        return self._samples.shape[0] / float(self._sample_rate)

    @property
    def num_samples(self):
        return int(self._samples.shape[0])

    def rms_db(self):
        mean_square = float(np.mean(self._samples ** 2))
        if mean_square <= 1e-30:
            return -100.0
        return 10.0 * np.log10(mean_square)

    def resample(self, target_sample_rate):
        if target_sample_rate == self._sample_rate:
            return self
        g = np.gcd(int(self._sample_rate), int(target_sample_rate))
        up, down = target_sample_rate // g, self._sample_rate // g
        self._samples = resample_poly(self._samples, up, down).astype(np.float32)
        self._sample_rate = int(target_sample_rate)
        return self

    def gain_db(self, gain):
        self._samples = self._samples * (10.0 ** (gain / 20.0))
        return self

    def normalize(self, target_db=-20, max_gain_db=300.0):
        """Gain the segment so its RMS reaches ``target_db`` dBFS."""
        gain = min(target_db - self.rms_db(), max_gain_db)
        return self.gain_db(gain)

    def to_bytes(self, dtype="int16"):
        if dtype == "int16":
            return (np.clip(self._samples, -1, 1) * 32767.0).astype("<i2").tobytes()
        if dtype == "float32":
            return self._samples.astype("<f4").tobytes()
        raise ValueError(f"unsupported dtype {dtype}")

    def to_wav_file(self, filepath):
        with wave.open(str(filepath), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(self._sample_rate)
            w.writeframes(self.to_bytes("int16"))

    def __len__(self):
        return self.num_samples

    def __repr__(self):
        return (f"AudioSegment(duration={self.duration:.3f}s, "
                f"sample_rate={self._sample_rate})")
