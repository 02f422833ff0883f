"""Threaded audio playback with position/seek (copy of the JAX package's
``infer_utils/player.py``; reference ``ppvector/infer_utils/player.py``).

Uses the ``soundcard`` package when present; otherwise playback is a
silent clock (position still advances) so the diarization viewer remains
usable on headless machines.
"""

import threading
import time

import numpy as np

from ..ops.audio import AudioSegment
from ..utils.logger import logger

__all__ = ["AudioPlayer"]


class AudioPlayer:
    def __init__(self, audio_path):
        seg = AudioSegment.from_file(audio_path)
        self.samples = seg.samples
        self.sample_rate = seg.sample_rate
        self.duration = seg.duration
        self.pos = 0.0            # seconds
        self.playing = False
        self._thread = None
        try:
            import soundcard
            self._speaker = soundcard.default_speaker()
        except Exception:  # noqa: BLE001 - no package or no device
            self._speaker = None
            logger.warning("no audio output device; AudioPlayer runs silent")

    def _run(self):
        block = 1024
        while self.playing:
            start = int(self.pos * self.sample_rate)
            if start >= len(self.samples):
                self.playing = False
                break
            chunk = self.samples[start:start + block]
            if self._speaker is not None:
                self._speaker.play(chunk, samplerate=self.sample_rate)
            else:
                time.sleep(len(chunk) / self.sample_rate)
            self.pos += len(chunk) / self.sample_rate

    def play(self):
        if self.playing:
            return
        self.playing = True
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def pause(self):
        self.playing = False

    def seek(self, seconds):
        self.pos = float(np.clip(seconds, 0.0, self.duration))

    def current_time(self):
        return self.pos
