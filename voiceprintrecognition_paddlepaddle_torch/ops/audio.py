"""Host-side audio container: decode / resample / normalize / crop / VAD.

Copy of the JAX package's ``ops/audio.py`` (numpy, scipy, the stdlib
``wave`` and the native library). WAV decode and resampling go through
the C++ library of ``native/`` first, in the same order as in the JAX
package: a file its decoder does not read goes to the stdlib / numpy
decoders; resampling is always the native Kaiser-windowed polyphase
filter, and a failed build of the library raises."""

import io
import random
import struct
import wave

import numpy as np

from ..native import decode_wav_native, resample_native

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
        with open(str(file), "rb") as f:
            decoded = decode_wav_native(f.read())
        if decoded is not None:
            return cls(*decoded)
        try:
            samples, rate = _decode_wav(str(file))
        except (wave.Error, EOFError):
            samples, rate = _decode_ieee_float_wav(str(file))
        return cls(samples, rate)

    @classmethod
    def from_bytes(cls, data: bytes):
        decoded = decode_wav_native(data)
        if decoded is not None:
            return cls(*decoded)
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
        self._samples = resample_native(self._samples, self._sample_rate,
                                        int(target_sample_rate))
        self._sample_rate = int(target_sample_rate)
        return self

    def gain_db(self, gain):
        self._samples = self._samples * (10.0 ** (gain / 20.0))
        return self

    def normalize(self, target_db=-20, max_gain_db=300.0):
        """Gain the segment so its RMS reaches ``target_db`` dBFS."""
        gain = min(target_db - self.rms_db(), max_gain_db)
        return self.gain_db(gain)

    def crop(self, duration, mode="eval"):
        """Keep ``duration`` seconds: random window in train mode, the
        leading window otherwise (reference ``reader.py:100-101``)."""
        num_keep = int(duration * self._sample_rate)
        if num_keep >= self._samples.shape[0]:
            return self
        if mode == "train":
            start = random.randint(0, self._samples.shape[0] - num_keep)
        else:
            start = 0
        self._samples = self._samples[start:start + num_keep]
        return self

    def pad_silence(self, duration, sides="end"):
        n = int(duration * self._sample_rate)
        pad = np.zeros(n, dtype=np.float32)
        if sides == "beginning":
            self._samples = np.concatenate([pad, self._samples])
        elif sides == "end":
            self._samples = np.concatenate([self._samples, pad])
        else:
            self._samples = np.concatenate([pad, self._samples, pad])
        return self

    # VAD (JAX ``ops/audio.py:223-374``)
    def vad(self, return_seconds=True, frame_ms=30, energy_offset_db=18.0,
            min_speech_ms=210, max_silence_ms=300, method="spectral",
            snr_trigger_db=2.5, snr_release_db=1.8, hangover_ms=240):
        """Voice-activity detection.

        ``method='spectral'`` (default, WebRTC-grade): frames at
        ``frame_ms``, computes per-frame power in six speech sub-bands
        (80–250, 250–500, 500–1k, 1–2k, 2–3k, 3–4k Hz), tracks a per-band
        noise floor with minimum statistics (sliding minimum + slow
        exponential rise), and derives a weighted band-SNR decision
        statistic. A hysteresis state machine triggers speech at
        ``snr_trigger_db``, releases below ``snr_release_db`` only after
        ``hangover_ms`` of low-SNR frames — the hangover bridges
        intra-utterance gaps the way WebRTC's VAD does. Robust to
        stationary and babble-like noise beds where a plain energy gate
        over- or under-segments.

        ``method='energy'``: the simple percentile-floor energy gate.

        Common postprocess: adjacent speech runs closer than
        ``max_silence_ms`` merge, runs shorter than ``min_speech_ms`` drop.
        Returns ``[{'start':, 'end':}, ...]`` in seconds (or samples if
        ``return_seconds=False``).
        """
        sr = self._sample_rate
        frame_len = max(1, int(sr * frame_ms / 1000))
        n_frames = len(self._samples) // frame_len
        if n_frames == 0:
            return []
        frames = self._samples[:n_frames * frame_len].reshape(
            n_frames, frame_len)

        if method == "spectral":
            speech = self._spectral_speech_mask(
                frames, sr, frame_ms, snr_trigger_db, snr_release_db,
                hangover_ms)
        elif method == "energy":
            speech = self._energy_speech_mask(frames, energy_offset_db)
        else:
            raise ValueError(f"unknown VAD method {method!r}")
        if not speech.any():
            return []

        # merge runs separated by short silence, drop short runs
        max_sil = max(1, int(max_silence_ms / frame_ms))
        min_spc = max(1, int(min_speech_ms / frame_ms))
        segments = []
        start = None
        silence = 0
        for i, s in enumerate(speech):
            if s:
                if start is None:
                    start = i
                silence = 0
            elif start is not None:
                silence += 1
                if silence > max_sil:
                    end = i - silence + 1
                    if end - start >= min_spc:
                        segments.append((start, end))
                    start, silence = None, 0
        if start is not None:
            end = n_frames - silence if silence else n_frames
            if end - start >= min_spc:
                segments.append((start, end))

        results = []
        for s, e in segments:
            a, b = s * frame_len, min(e * frame_len, len(self._samples))
            if return_seconds:
                results.append({"start": a / sr, "end": b / sr})
            else:
                results.append({"start": a, "end": b})
        return results

    @staticmethod
    def _energy_speech_mask(frames, energy_offset_db):
        """Percentile-floor energy gate (the round-1 VAD)."""
        energy = 10.0 * np.log10(np.mean(frames ** 2, axis=1) + 1e-12)
        floor = np.percentile(energy, 10)
        # speech-dominated audio can push the percentile floor up to the
        # speech level; cap the threshold at peak-12 dB, and require an
        # absolute minimum so silence never counts as speech
        threshold = min(floor + energy_offset_db, energy.max() - 12.0)
        threshold = max(threshold, -55.0)
        return energy > threshold

    @staticmethod
    def _spectral_speech_mask(frames, sr, frame_ms, trigger_db, release_db,
                              hangover_ms):
        from scipy.ndimage import percentile_filter, uniform_filter1d

        n_frames, frame_len = frames.shape
        win = np.hanning(frame_len).astype(np.float32)
        spec = np.abs(np.fft.rfft(frames * win, axis=1)) ** 2  # (T, bins)
        freqs = np.fft.rfftfreq(frame_len, 1.0 / sr)

        bands = [(80, 250), (250, 500), (500, 1000),
                 (1000, 2000), (2000, 3000), (3000, 4000)]
        # voiced energy concentrates low; weight like WebRTC's band gains
        weights = np.array([1.0, 1.0, 1.0, 0.8, 0.6, 0.5])
        band_pow = np.stack(
            [spec[:, (freqs >= lo) & (freqs < hi)].sum(axis=1)
             for lo, hi in bands], axis=1) + 1e-12            # (T, 6)
        log_p = 10.0 * np.log10(band_pow)

        # per-band noise floor: 20th-percentile over a sliding ~2 s window
        # (robust to level wander; a pure minimum underestimates modulated
        # noise beds and never releases). Capped at the global 10th
        # percentile + 6 dB so sustained speech cannot push its own floor
        # up to speech level (the speech-dominated-audio failure mode).
        win_frames = max(3, int(2000 / frame_ms)) | 1
        noise = percentile_filter(log_p, 20, size=(win_frames, 1))
        noise = np.minimum(noise,
                           np.percentile(log_p, 10, axis=0) + 6.0)

        snr = np.maximum(log_p - noise, 0.0)                  # (T, 6) dB
        stat = (snr * weights).sum(axis=1) / weights.sum()    # weighted dB
        # speech is sustained: a ~200 ms average separates utterances from
        # noise-bed flicker that instantaneous frames cannot
        stat = uniform_filter1d(stat, size=max(1, int(210 / frame_ms)))

        # absolute floor: silence (even digitally clean) is never speech
        abs_energy = 10.0 * np.log10(np.mean(frames ** 2, axis=1) + 1e-12)
        audible = abs_energy > -55.0

        # hysteresis + hangover state machine
        hang = max(1, int(hangover_ms / frame_ms))
        speech = np.zeros(n_frames, dtype=bool)
        in_speech = False
        low = 0
        for t in range(n_frames):
            if not in_speech:
                if stat[t] >= trigger_db and audible[t]:
                    in_speech = True
                    low = 0
            else:
                if stat[t] < release_db or not audible[t]:
                    low += 1
                    if low > hang:
                        in_speech = False
                else:
                    low = 0
            speech[t] = in_speech and audible[t]

        # wall-to-wall audio (no quiet stretch to anchor the noise floor):
        # when almost nothing triggered yet most frames carry energy,
        # treat the audible frames as speech — matching the permissive
        # behaviour of yeaudio's VAD on continuous speech
        if speech.mean() < 0.1 and audible.mean() > 0.5:
            return audible
        return speech

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
