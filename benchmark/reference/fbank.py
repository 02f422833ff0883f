"""Kaldi's fbank (``compute-fbank-feats`` defaults: 25 ms frames every
10 ms with snip edges, no dither, DC removal, pre-emphasis 0.97 with the
first sample repeated, the povey window, a 512-point FFT, the power, 80
triangular mel filters from 20 Hz to Nyquist, the log floored at float32's
epsilon) and the per-utterance CMN over the valid frames, in float64."""

import math

import numpy as np
import torch

FRAME_LEN, SHIFT, N_FFT = 400, 160, 512
LOG_FLOOR = float(np.finfo(np.float32).eps)


def num_frames(num_samples):
    return 0 if num_samples < FRAME_LEN else 1 + (num_samples - FRAME_LEN) // SHIFT


def mel_banks(n_mels=80, sr=16000, low=20.0, high=0.0):
    """``(N_FFT // 2 + 1, n_mels)`` triangles on the mel scale (kaldi
    ``MelBanks``), the Nyquist row zero."""
    def mel(f):
        return 1127.0 * np.log(1.0 + f / 700.0)
    high = sr / 2.0 + high if high <= 0 else high
    lo, hi = mel(low), mel(high)
    delta = (hi - lo) / (n_mels + 1)
    bins = mel(sr / N_FFT * np.arange(N_FFT // 2))[None, :]
    left = lo + np.arange(n_mels)[:, None] * delta
    center, right = left + delta, left + 2 * delta
    bank = np.maximum(0.0, np.minimum((bins - left) / (center - left),
                                      (right - bins) / (right - center)))
    return np.concatenate([bank, np.zeros((n_mels, 1))], axis=1).T


def fbank(waves, n_mels=80):
    """``(B, L)`` waveforms -> ``(B, T, n_mels)`` float64 log-mel."""
    x = waves.to(torch.float64)
    t = num_frames(x.shape[-1])
    frames = x[:, :(t - 1) * SHIFT + FRAME_LEN].unfold(-1, FRAME_LEN, SHIFT)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    k = torch.arange(FRAME_LEN, dtype=torch.float64, device=x.device)
    window = (0.5 - 0.5 * torch.cos(2 * math.pi * k / (FRAME_LEN - 1))) ** 0.85
    frames = (frames - 0.97 * prev) * window
    spec = torch.fft.rfft(frames, n=N_FFT)
    power = spec.real ** 2 + spec.imag ** 2
    bank = torch.from_numpy(mel_banks(n_mels)).to(x.device)
    return torch.log(torch.clamp(power @ bank, min=LOG_FLOOR))


def cmn(feats, ratios=None):
    """Subtract each utterance's mean over its first ``int(ratio * T)``
    frames (the ratio and the product in float32) and zero the rest."""
    t = feats.shape[1]
    if ratios is None:
        return feats - feats.mean(dim=1, keepdim=True)
    r = torch.as_tensor(np.asarray(ratios, np.float32), device=feats.device)
    lens = (r * t).to(torch.int32)
    mask = (torch.arange(t, device=feats.device)[None, :, None]
            < lens[:, None, None])
    mean = (torch.where(mask, feats, 0.0).sum(dim=1, keepdim=True)
            / torch.clamp(mask.sum(dim=1, keepdim=True), min=1))
    return torch.where(mask, feats - mean, 0.0)


def features(waves, ratios=None, n_mels=80):
    return cmn(fbank(waves, n_mels), ratios)
