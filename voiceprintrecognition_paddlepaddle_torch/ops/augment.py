"""Audio augmentation: host-side speed perturb and batched augments on the
device (counterpart of the JAX ``ops/augment.py``).

The reference applies five ``yeaudio`` augmentors per sample on CPU workers
(reference ``ppvector/data_utils/reader.py:141-163``: speed, volume, noise,
reverb on the waveform, SpecAugment on the feature). As in the JAX package:

- **speed perturb** changes the length, so it runs on the host while the
  batch is decoded (copied: ``SpeedPerturbAugmentor``, Python
  ``random.Random``), with the optional 3-class label ``spk_id * 3 + idx``;
- **volume, noise, reverb, dB normalisation, SpecAugment** are batched
  tensor functions on fixed-shape ``(B, L)`` waveforms and ``(B, T, F)``
  features on the batch's device. Their draws come from an explicit
  ``torch.Generator`` (JAX: a PRNG key), so they differ from JAX's draws
  but not in distribution; each draw's deterministic core
  (``apply_volume``, ``mix_noise``, ``apply_reverb``, ``normalize_db``,
  ``warp_time``, ``spec_masks``) computes what the JAX function does with
  the same draws. Noise and RIR clips are preloaded banks (``AudioBank``).
"""

import os
import random

import numpy as np
import torch

from ..native import resample_native
from .audio import AudioSegment

__all__ = ["SpeedPerturbAugmentor", "DeviceAugmenter", "AudioBank",
           "load_audio_bank", "spec_augment", "spec_masks", "time_warp",
           "warp_time", "mix_noise", "apply_reverb", "apply_volume",
           "normalize_db", "rms_db"]


# ----------------------------------------------------------------------
# host side: speed perturbation (changes length), copied from JAX
# ----------------------------------------------------------------------
class SpeedPerturbAugmentor:
    """Random speed in {0.9, 1.0, 1.1} by polyphase resampling (the
    native Kaiser resampler); with ``speed_perturb_3_class`` the label
    becomes ``spk_id * 3 + idx`` and the classifier grows 3x. The output
    length is exactly ``int(len / speed)``."""

    SPEEDS = (1.0, 0.9, 1.1)
    # up/down polyphase ratios for 1/speed
    _RATIOS = {0.9: (10, 9), 1.1: (10, 11)}

    def __init__(self, prob=1.0, speed_perturb_3_class=False,
                 num_speakers=None, **kwargs):
        self.prob = prob
        self.speed_perturb_3_class = speed_perturb_3_class
        self.num_speakers = num_speakers

    @classmethod
    def resample(cls, samples, speed):
        """Time-stretch by 1/speed with anti-aliasing."""
        new_len = int(len(samples) / speed)
        up, down = cls._RATIOS[speed]
        out = resample_native(np.asarray(samples, np.float32), down, up)
        if len(out) < new_len:
            out = np.pad(out, (0, new_len - len(out)))
        return out[:new_len].astype(np.float32)

    def sample(self, spk_id, rng: random.Random = random):
        """Draw the per-item policy once: ``(num, den, spk_id)``, the
        playback speed ``num/den`` ((9, 10) = 0.9x) and the label. Both
        the per-item path and the native batch loader
        (``reader.load_batch``) take it from here."""
        if rng.random() >= self.prob:
            return 1, 1, spk_id
        idx = rng.randint(0, 2)
        speed = self.SPEEDS[idx]
        if self.speed_perturb_3_class:
            spk_id = spk_id * 3 + idx
        if speed == 1.0:
            return 1, 1, spk_id
        up, down = self._RATIOS[speed]
        return down, up, spk_id

    def __call__(self, samples, spk_id, rng: random.Random = random):
        num, den, spk_id = self.sample(spk_id, rng)
        if num != den:
            samples = self.resample(samples, num / den)
        return samples, spk_id


class AudioBank:
    """A refreshable fixed-shape ``(N, L)`` bank of audio clips for noise
    and reverb augmentation (JAX ``augment.py:104-180``).

    Each step draws a clip and a circular offset per sample from the bank;
    a corpus larger than ``max_clips`` gets a new random subset of files,
    each with a random crop window, at every epoch (``bank(epoch)``).
    ``pad_mode``: "tile" repeats short clips (noise); "zero" zero-pads
    (RIRs: tiling an impulse response would make echoes). ``bank``
    returns a CPU tensor; ``DeviceAugmenter.device_banks`` moves it."""

    _has_long_clips = True  # unknown before the first load: assume yes

    def __init__(self, audio_dir, sample_rate, clip_seconds, max_clips=256,
                 pad_mode="tile", seed=0):
        self.paths = sorted(
            os.path.join(audio_dir, f) for f in os.listdir(audio_dir)
            if f.lower().endswith((".wav", ".flac")))
        self.sample_rate = sample_rate
        self.length = int(clip_seconds * sample_rate)
        self.max_clips = int(max_clips)
        self.pad_mode = pad_mode
        self.seed = seed
        self._bank = None
        self._epoch = None

    def __bool__(self):
        return bool(self.paths)

    @property
    def needs_refresh(self):
        """True when a refresh would change the bank: more files than rows,
        or clips longer than a row (new crop windows)."""
        return len(self.paths) > self.max_clips or self._has_long_clips

    def bank(self, epoch=0):
        """The ``(N, L)`` bank for this epoch (cached; reloaded on a new
        epoch only when a refresh would change it)."""
        if self._bank is not None and (
                epoch == self._epoch or not self.needs_refresh):
            return self._bank
        rng = np.random.RandomState((self.seed + 7919 * epoch) % (2 ** 31))
        if len(self.paths) > self.max_clips:
            idx = rng.choice(len(self.paths), self.max_clips, replace=False)
            paths = [self.paths[i] for i in sorted(idx)]
        else:
            paths = self.paths
        bank = np.zeros((len(paths), self.length), dtype=np.float32)
        self._has_long_clips = False
        for i, p in enumerate(paths):
            seg = AudioSegment.from_file(p)
            seg.resample(self.sample_rate)
            s = seg.samples
            if len(s) < self.length:
                if self.pad_mode == "tile":
                    s = np.tile(s, self.length // len(s) + 1)[:self.length]
                else:
                    s = np.pad(s, (0, self.length - len(s)))
            elif len(s) > self.length:
                self._has_long_clips = True
                start = rng.randint(0, len(s) - self.length + 1)
                s = s[start:start + self.length]
            bank[i] = s[:self.length]
        self._bank = torch.from_numpy(bank)
        self._epoch = epoch
        return self._bank


def load_audio_bank(audio_dir, sample_rate, clip_seconds, max_clips=256,
                    pad_mode="tile"):
    """One-shot bank load (see ``AudioBank``); None when the directory is
    missing or holds no audio."""
    if audio_dir is None or not os.path.isdir(audio_dir):
        return None
    b = AudioBank(audio_dir, sample_rate, clip_seconds, max_clips, pad_mode)
    return b.bank(0) if b else None


# ----------------------------------------------------------------------
# tensor functions on the batch's device
# ----------------------------------------------------------------------
def rms_db(waves, valid_ratio=None):
    """RMS in dB over the last axis; ``valid_ratio`` corrects for
    zero-padded tails, so a padded row gives its unpadded RMS."""
    mean_sq = torch.mean(waves ** 2, dim=-1)
    if valid_ratio is not None:
        mean_sq = mean_sq / torch.clamp(valid_ratio, min=1e-6)
    return 10.0 * torch.log10(torch.clamp(mean_sq, min=1e-30))


def normalize_db(waves, target_db=-20.0, max_gain_db=300.0,
                 valid_ratio=None):
    """Batched RMS normalisation (reference ``reader.py:97-98``)."""
    gain = torch.clamp(target_db - rms_db(waves, valid_ratio), max=max_gain_db)
    return waves * 10.0 ** (gain[..., None] / 20.0)


def apply_volume(waves, gain_db):
    """Per-sample gain in dB."""
    return waves * 10.0 ** (gain_db[..., None] / 20.0)


def mix_noise(waves, noise, snr_db, valid_ratio=None):
    """Add noise clips gained to ``rms(wave) - snr_db``."""
    noise_gain = rms_db(waves, valid_ratio) - rms_db(noise) - snr_db
    return waves + noise * 10.0 ** (noise_gain[..., None] / 20.0)


def apply_reverb(waves, rir):
    """FFT convolution with per-sample room impulse responses, rescaled to
    the dry signal's peak. ``waves (B, L)``, ``rir (B, R)`` -> ``(B, L)``."""
    length, r = waves.shape[-1], rir.shape[-1]
    nfft = 1 << (length + r - 2).bit_length()
    rir = rir / torch.clamp(
        torch.sqrt(torch.sum(rir ** 2, dim=-1, keepdim=True)), min=1e-8)
    out = torch.fft.irfft(torch.fft.rfft(waves, nfft)
                          * torch.fft.rfft(rir, nfft), nfft)[..., :length]
    peak_dry = torch.amax(torch.abs(waves), dim=-1, keepdim=True)
    peak_wet = torch.amax(torch.abs(out), dim=-1, keepdim=True)
    return out * peak_dry / torch.clamp(peak_wet, min=1e-8)


def _randint(gen, low, high, size, device):
    return torch.randint(low, high, size, generator=gen, device=device)


def _uniform(gen, size, device, low=0.0, high=1.0):
    return low + (high - low) * torch.rand(size, generator=gen, device=device)


def warp_time(features, center, dest):
    """Piecewise-linear warp of the time axis of ``(B, T, F)``: frame
    ``center[b]`` moves to ``dest[b]``, with linear interpolation (JAX
    ``time_warp`` given its draws)."""
    b, t, f = features.shape
    pos = torch.arange(t, dtype=torch.float32, device=features.device)[None]
    c = center.to(torch.float32)[:, None]
    d = dest.to(torch.float32)[:, None]
    left = pos * c / torch.clamp(d, min=1.0)
    right = c + (pos - d) * (t - 1 - c) / torch.clamp(t - 1 - d, min=1.0)
    src = torch.clamp(torch.where(pos <= d, left, right), 0.0, t - 1.0)
    lo = torch.floor(src).to(torch.int64)
    hi = torch.clamp(lo + 1, max=t - 1)
    frac = (src - lo)[..., None]

    def gather(idx):
        return torch.gather(features, 1, idx[..., None].expand(-1, -1, f))
    return gather(lo) * (1 - frac) + gather(hi) * frac


def time_warp(features, gen, max_time_warp=5):
    """SpecAugment time warping with draws from ``gen``: a source frame in
    ``[w, T - w)`` moves by up to ``w`` frames either way."""
    b, t, _ = features.shape
    w = int(max_time_warp)
    if w == 0 or t - 2 * w <= 0:
        return features
    center = _randint(gen, w, t - w, (b,), features.device)
    dest = center + _randint(gen, -w, w + 1, (b,), features.device)
    return warp_time(features, center, dest)


def spec_masks(features, t_starts, f_starts, t_width, f_width):
    """Zero ``t_width`` frames from each of ``t_starts (B, n)`` and
    ``f_width`` bins from each of ``f_starts (B, n)``."""
    def keep(starts, dim, width):
        idx = torch.arange(dim, device=features.device)[None, :, None]
        hit = (idx >= starts[:, None, :]) & (idx < (starts + width)[:, None, :])
        return ~torch.any(hit, dim=-1)
    b, t, f = features.shape
    keep_t = keep(t_starts, t, t_width)[:, :, None]
    keep_f = keep(f_starts, f, f_width)[:, None, :]
    return features * keep_t * keep_f


def spec_augment(features, gen, freq_mask_ratio=0.1, n_freq_masks=1,
                 time_mask_ratio=0.05, n_time_masks=1, prob=0.5,
                 max_time_warp=0):
    """Batched SpecAugment on ``(B, T, F)``: per-sample time and frequency
    zero masks ``ratio * dim`` wide and optional time warping, applied to
    each sample with probability ``prob`` (JAX ``augment.py:274-303``)."""
    b, t, f = features.shape
    dev = features.device
    f_width = max(int(f * freq_mask_ratio), 1)
    t_width = max(int(t * time_mask_ratio), 1)
    apply = _uniform(gen, (b, 1, 1), dev) < prob
    if max_time_warp:
        features = torch.where(apply, time_warp(features, gen, max_time_warp),
                               features)
    t_starts = _randint(gen, 0, max(t - t_width, 1), (b, n_time_masks), dev)
    f_starts = _randint(gen, 0, max(f - f_width, 1), (b, n_freq_masks), dev)
    masked = spec_masks(features, t_starts, f_starts, t_width, f_width)
    return torch.where(apply, masked, features)


class DeviceAugmenter:
    """The train step's augmentation chain, built from the augmentation
    YAML (keys volume / noise / reverb / spec_aug; JAX
    ``augment.py:306-410``). ``__call__(waves, gen)`` applies volume, noise
    and reverb in the reference's order (``reader.py:154-163``) and then
    the dB normalization to ``target_db``, on every call;
    ``augment_features`` applies SpecAugment."""

    def __init__(self, aug_conf, sample_rate, clip_seconds, target_db=None):
        self.volume_conf = aug_conf.get("volume") if aug_conf else None
        self.noise_conf = aug_conf.get("noise") if aug_conf else None
        self.reverb_conf = aug_conf.get("reverb") if aug_conf else None
        self.spec_conf = aug_conf.get("spec_aug") if aug_conf else None
        self.target_db = target_db
        self._noise = self._rir = None
        if self.noise_conf and self.noise_conf.get("prob", 0) > 0:
            d = self.noise_conf.get("noise_dir")
            if d and os.path.isdir(d):
                self._noise = AudioBank(
                    d, sample_rate, clip_seconds,
                    max_clips=int(self.noise_conf.get("max_clips", 256)),
                    pad_mode="tile") or None
        if self.reverb_conf and self.reverb_conf.get("prob", 0) > 0:
            d = self.reverb_conf.get("reverb_dir")
            if d and os.path.isdir(d):
                # full-length RIRs (up to the training crop), zero-padded
                self._rir = AudioBank(
                    d, sample_rate,
                    float(self.reverb_conf.get("max_rir_seconds",
                                               clip_seconds)),
                    max_clips=int(self.reverb_conf.get("max_clips", 256)),
                    pad_mode="zero") or None

    def device_banks(self, epoch=0, device="cpu"):
        """This epoch's banks on ``device`` (refreshed per epoch when the
        corpus exceeds the bank)."""
        return {"noise": self._noise.bank(epoch).to(device)
                if self._noise else None,
                "rir": self._rir.bank(epoch).to(device) if self._rir else None}

    def __call__(self, waves, gen, valid_ratio=None, banks=None):
        banks = banks or self.device_banks(device=waves.device)
        b, dev = waves.shape[0], waves.device
        if self.volume_conf and self.volume_conf.get("prob", 0) > 0:
            gain = _uniform(gen, (b,), dev,
                            float(self.volume_conf.get("min_gain_dBFS", -15)),
                            float(self.volume_conf.get("max_gain_dBFS", 15)))
            on = _uniform(gen, (b,), dev) < self.volume_conf["prob"]
            waves = torch.where(on[:, None], apply_volume(waves, gain), waves)
        if banks.get("noise") is not None:
            bank = banks["noise"]
            n, length = bank.shape
            idx = _randint(gen, 0, n, (b,), dev)
            snr = _uniform(gen, (b,), dev,
                           float(self.noise_conf.get("min_snr_dB", 10)),
                           float(self.noise_conf.get("max_snr_dB", 50)))
            # a random segment per sample: a circular offset into the clip
            shift = _randint(gen, 0, length, (b,), dev)
            cols = (torch.arange(length, device=dev)[None] - shift[:, None]) \
                % length
            noise = torch.gather(bank[idx], 1, cols)[:, :waves.shape[1]]
            on = _uniform(gen, (b,), dev) < self.noise_conf["prob"]
            waves = torch.where(on[:, None],
                                mix_noise(waves, noise, snr, valid_ratio),
                                waves)
        if banks.get("rir") is not None:
            bank = banks["rir"]
            idx = _randint(gen, 0, bank.shape[0], (b,), dev)
            on = _uniform(gen, (b,), dev) < self.reverb_conf["prob"]
            waves = torch.where(on[:, None], apply_reverb(waves, bank[idx]),
                                waves)
        if self.target_db is not None:
            waves = normalize_db(waves, self.target_db,
                                 valid_ratio=valid_ratio)
        return waves

    def augment_features(self, features, gen):
        if not self.spec_conf or self.spec_conf.get("prob", 0) <= 0:
            return features
        return spec_augment(
            features, gen,
            freq_mask_ratio=float(self.spec_conf.get("freq_mask_ratio", 0.1)),
            n_freq_masks=int(self.spec_conf.get("n_freq_masks", 1)),
            time_mask_ratio=float(self.spec_conf.get("time_mask_ratio", 0.05)),
            n_time_masks=int(self.spec_conf.get("n_time_masks", 1)),
            max_time_warp=int(self.spec_conf.get("max_time_warp", 0)),
            prob=float(self.spec_conf.get("prob", 0.5)))
