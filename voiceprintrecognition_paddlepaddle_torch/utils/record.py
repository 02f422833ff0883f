"""Microphone recording (copy of the JAX package's ``utils/record.py``;
reference ``ppvector/utils/record.py``).

It records with the ``soundcard`` package when that imports and finds a
microphone; otherwise ``record()`` raises a clear error, and callers pass
file paths or arrays to the Predictor instead.
"""

import numpy as np

from .logger import logger

__all__ = ["RecordAudio"]


class RecordAudio:
    def __init__(self, channels=1, sample_rate=16000):
        self.channels = channels
        self.sample_rate = sample_rate
        try:
            import soundcard
            self._mic = soundcard.default_microphone()
        except Exception:  # noqa: BLE001 - no package or no device
            self._mic = None
            logger.warning("no audio input device / soundcard package; "
                           "RecordAudio.record() is unavailable")

    def record(self, record_seconds=3, save_path=None):
        """Record ``record_seconds`` of mono float32 audio."""
        if self._mic is None:
            raise RuntimeError(
                "audio recording unavailable (no soundcard backend); "
                "pass a wav path or numpy array to the Predictor instead")
        print("start recording...")
        data = self._mic.record(samplerate=self.sample_rate,
                                numframes=self.sample_rate * record_seconds)
        audio = np.asarray(data, dtype=np.float32)
        if audio.ndim == 2:
            audio = audio.mean(axis=1)
        print("recording done")
        if save_path is not None:
            from ..ops.audio import AudioSegment
            AudioSegment(audio, self.sample_rate).to_wav_file(save_path)
        return audio
