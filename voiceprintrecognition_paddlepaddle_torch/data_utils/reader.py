"""List-file dataset (counterpart of the JAX ``data_utils/reader.py``,
host code copied).

Tab-separated ``path\tspk_id`` lists, the min-duration skip, resampling,
dB normalisation, the train crop, precomputed ``.npy`` features and the
eval sort by duration (reference ``ppvector/data_utils/reader.py:16-163``).
In waveform mode the dataset returns **raw fixed-length waveforms**
(cropped or zero-padded to ``max_duration``) and the valid length; the
other DSP (volume, noise, reverb, dB normalisation, Fbank, SpecAugment)
runs batched on the device in the train step. Speed perturbation, the one
augmentation that changes the length, runs here on the host, with the
optional 3-class label expansion.
"""

import random

import numpy as np

from ..ops.audio import AudioSegment
from ..ops.augment import SpeedPerturbAugmentor

__all__ = ["SpeakerDataset"]


class SpeakerDataset:
    """Modes: 'train' | 'eval' | 'extract_feature' (reference
    ``reader.py:43``).

    Items:
      - waveform mode: ``(waveform float32 (L,), spk_id, valid_len)`` where
        L = max_duration * sample_rate in train mode (crop/pad) and the
        natural (capped) length otherwise;
      - ``.npy`` mode: ``(feature (T, F), spk_id, T)`` with random train crop.
    """

    def __init__(self,
                 data_list_path,
                 max_duration=3,
                 min_duration=0.5,
                 mode="train",
                 sample_rate=16000,
                 aug_conf=None,
                 num_speakers=None,
                 use_dB_normalization=True,
                 target_dB=-20,
                 max_feature_len=None,
                 seed=None):
        assert mode in ("train", "eval", "extract_feature")
        self.max_duration = max_duration
        self.min_duration = min_duration
        self.mode = mode
        self.sample_rate = sample_rate
        self.use_dB_normalization = use_dB_normalization
        self.target_dB = target_dB
        self.num_speakers = num_speakers
        self.max_feature_len = max_feature_len  # frames for .npy train crop
        self._rng = random.Random(seed)

        with open(data_list_path, "r", encoding="utf-8") as f:
            self.lines = [ln.strip() for ln in f if ln.strip()]
        self.labels = [np.int64(ln.split("\t")[1]) for ln in self.lines]

        self.speed_augment = None
        if mode == "train" and aug_conf is not None:
            speed_conf = aug_conf.get("speed")
            if speed_conf is not None and speed_conf.get("prob", 0) > 0:
                self.speed_augment = SpeedPerturbAugmentor(
                    num_speakers=num_speakers, **speed_conf)

        if self.mode == "eval":
            self.sort_by_duration()

    def __len__(self):
        return len(self.lines)

    @property
    def speed_perturb_3_class(self):
        return bool(self.speed_augment
                    and self.speed_augment.speed_perturb_3_class)

    def sort_by_duration(self):
        """Sort the eval list short→long so padded batches are tight
        (reference ``reader.py:122-138``)."""
        lengths = []
        for ln in self.lines:
            path = ln.split("\t")[0]
            if path.endswith(".npy"):
                lengths.append(np.load(path, mmap_mode="r").shape[0])
            else:
                lengths.append(AudioSegment.from_file(path).duration)
        order = np.argsort(lengths)
        self.lines = [self.lines[i] for i in order]
        self.labels = [self.labels[i] for i in order]

    def load_batch(self, indices, n_threads=None):
        """Native path for train waveform batches: one GIL-free C++ call
        reads, decodes, resamples (sample rate x speed perturb), crops and
        int16-quantizes the whole batch in a thread pool
        (``native/audioio.cpp`` ``vpr_load_batch``). The speed, label and
        crop draws stay in Python (the per-item path's policy). Returns
        items ``[(int16 (L,), label, valid), ...]``, or None outside train
        mode and for ``.npy`` lists; unreadable or too-short items take
        ``__getitem__``'s skip to the next item."""
        if self.mode != "train":
            return None
        from ..native import load_batch_native
        paths, labels, speeds, fracs = [], [], [], []
        for idx in indices:
            path, spk_id = self.lines[idx].split("\t")
            if path.endswith(".npy"):
                return None
            spk_id = int(spk_id)
            num, den = 1, 1
            sa = self.speed_augment
            if sa is not None:
                # one source of truth for the prob/speed/label policy
                num, den, spk_id = sa.sample(spk_id, self._rng)
            paths.append(path)
            labels.append(spk_id)
            speeds.append((num, den))
            fracs.append(self._rng.random())
        target_len = int(self.max_duration * self.sample_rate)
        waves, valid, dur = load_batch_native(paths, self.sample_rate,
                                              target_len, speeds, fracs,
                                              n_threads)
        items = []
        for i, idx in enumerate(indices):
            if valid[i] < 0 or dur[i] < self.min_duration:
                # unreadable / too short: same skip-to-next semantics as
                # the per-item path (reference ``reader.py:87-89``)
                items.append(self[idx + 1 if idx < len(self) - 1 else 0])
            else:
                items.append((waves[i], labels[i], int(valid[i])))
        return items

    def __getitem__(self, idx):
        path, spk_id = self.lines[idx].split("\t")
        spk_id = int(spk_id)

        if path.endswith(".npy"):
            feature = np.load(path)
            if (self.max_feature_len
                    and feature.shape[0] > self.max_feature_len):
                start = (self._rng.randint(
                    0, feature.shape[0] - self.max_feature_len)
                    if self.mode == "train" else 0)
                feature = feature[start:start + self.max_feature_len]
            return feature.astype(np.float32), spk_id, feature.shape[0]

        seg = AudioSegment.from_file(path)
        if self.mode in ("train", "extract_feature"):
            if seg.duration < self.min_duration:
                # too short to train on: fall through to the next item
                # (reference ``reader.py:87-89``)
                return self[idx + 1 if idx < len(self) - 1 else 0]
        if seg.sample_rate != self.sample_rate:
            seg.resample(self.sample_rate)

        samples = seg.samples
        if self.mode == "train" and self.speed_augment is not None:
            samples, spk_id = self.speed_augment(samples, spk_id, self._rng)

        if self.use_dB_normalization and self.mode != "train":
            # train-mode dB norm runs on device after the other augments
            seg2 = AudioSegment(samples, self.sample_rate)
            seg2.normalize(target_db=self.target_dB)
            samples = seg2.samples

        target_len = int(self.max_duration * self.sample_rate)
        if self.mode != "extract_feature" and len(samples) > target_len:
            start = (self._rng.randint(0, len(samples) - target_len)
                     if self.mode == "train" else 0)
            samples = samples[start:start + target_len]

        valid = len(samples)
        if self.mode == "train" and valid < target_len:
            # static train shapes: zero-pad short clips, keep valid length
            samples = np.pad(samples, (0, target_len - valid))
        return samples.astype(np.float32), spk_id, valid
