"""Audio feature front end (counterpart of the JAX ``ops/features.py``):
Fbank, MFCC, MelSpectrogram, LogMelSpectrogram and Spectrogram, with
per-utterance CMN and tail masking.

Fbank is dispatched as the JAX ``_fbank_dispatch`` does it, by the options
alone: the stock kaldi options at 16 kHz without dither go to
``fbank_kernel.fbank_fused`` (the CUDA kernel on a CUDA tensor, its plain
version on a CPU tensor); any other Fbank goes to the plain
``kaldi.fbank`` on the same device, as JAX sends it to XLA. A kernel that
fails to build or launch raises; it never changes the route.

The other methods mirror ``paddle.audio.features`` (n_fft 512, hann,
centred frames with reflected edges, Slaney mel banks, f_min 50). Their
STFT is a product with the real-DFT matrix in plain fp32 torch, as the
JAX package computes it outside any kernel.

Output convention as in the JAX package: ``(B, T, F)``, CMN over the
valid frames only when length ratios are given. The default method is the
JAX package's, ``"MelSpectrogram"``.
"""

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from . import kaldi
from .fbank_kernel import fbank_fused

__all__ = ["AudioFeaturizer", "spectrogram", "mel_spectrogram",
           "log_mel_spectrogram", "mfcc", "fbank_dispatch",
           "compute_feature", "apply_cmn_and_mask"]


# ----------------------------------------------------------------------
# mel / dct helper matrices (host-side, cached; copies of the JAX module's)
# ----------------------------------------------------------------------
def _hz_to_mel(f, htk=False):
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep,
                    mels)


def _mel_to_hz(m, htk=False):
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    freqs)


@lru_cache(maxsize=None)
def _slaney_mel_banks_np(sr, n_fft, n_mels, f_min, f_max, htk, norm):
    """librosa / paddle mel filterbank: ``(n_fft//2+1, n_mels)``."""
    if f_max is None:
        f_max = sr / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sr / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel(f_min, htk), _hz_to_mel(f_max, htk),
                          n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
        weights *= enorm[:, None]
    return weights.T.astype(np.float32)


@lru_cache(maxsize=None)
def _dct_matrix_np(n_mfcc, n_mels):
    """DCT-II with 'ortho' norm: ``(n_mels, n_mfcc)``."""
    n = np.arange(n_mels)[:, None]
    k = np.arange(n_mfcc)[None, :]
    mat = np.cos(math.pi * (2 * n + 1) * k / (2 * n_mels)) \
        * math.sqrt(2.0 / n_mels)
    mat[:, 0] = math.sqrt(1.0 / n_mels)
    return mat.astype(np.float32)


@lru_cache(maxsize=None)
def _hann_np(n):
    return (0.5 - 0.5 * np.cos(2 * math.pi * np.arange(n) / n)).astype(
        np.float32)


@lru_cache(maxsize=None)
def _reflect_index(n, pad):
    """Indices of ``np.pad(x, pad, mode="reflect")`` for a length-``n`` x:
    the reflection repeats when ``pad >= n``, where ``F.pad`` refuses."""
    i = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.mod(i, period)
    return np.where(i >= n, period - i, i)


# ----------------------------------------------------------------------
# centred STFT as a product with the real-DFT matrix
# ----------------------------------------------------------------------
def _stft_power(waveforms, n_fft, hop_length, win_length, window, center,
                pad_mode, power):
    """``(B, L) -> (B, T, n_fft//2+1)`` magnitude**power spectrogram."""
    x = torch.as_tensor(waveforms, dtype=torch.float32)
    if win_length is None:
        win_length = n_fft
    if hop_length is None:
        hop_length = win_length // 4
    if center:
        pad = n_fft // 2
        if pad_mode == "reflect":
            idx = _reflect_index(x.shape[-1], pad)
            x = x[..., kaldi._table(idx, x.device)]
        elif pad_mode == "constant":
            x = F.pad(x, (pad, pad))
        else:
            raise ValueError(f"unsupported pad_mode {pad_mode!r}")
    frames = kaldi.frame_signal(x, n_fft, hop_length)
    win = (_hann_np(win_length) if window == "hann"
           else kaldi._window_np(window, win_length))
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        win = np.pad(win, (lpad, n_fft - win_length - lpad))
    spec = (frames * kaldi._table(win, x.device)) @ kaldi._table(
        kaldi._rdft_np(n_fft, n_fft), x.device)
    n_bins = n_fft // 2 + 1
    mag_sq = spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2
    if power == 2.0:
        return mag_sq
    if power == 1.0:
        return torch.sqrt(torch.clamp(mag_sq, min=0.0))
    return torch.pow(torch.clamp(mag_sq, min=1e-30), power / 2.0)


def spectrogram(waveforms, sr=16000, n_fft=512, hop_length=None,
                win_length=None, window="hann", power=1.0, center=True,
                pad_mode="reflect"):
    """``paddle.audio.features.Spectrogram``: ``(B, T, n_fft//2+1)``."""
    return _stft_power(waveforms, n_fft, hop_length, win_length, window,
                       center, pad_mode, power)


def mel_spectrogram(waveforms, sr=16000, n_fft=512, hop_length=None,
                    win_length=None, window="hann", power=2.0, center=True,
                    pad_mode="reflect", n_mels=64, f_min=50.0, f_max=None,
                    htk=False, norm="slaney"):
    """``paddle.audio.features.MelSpectrogram``: ``(B, T, n_mels)``."""
    spec = _stft_power(waveforms, n_fft, hop_length, win_length, window,
                       center, pad_mode, power)
    return spec @ kaldi._table(_slaney_mel_banks_np(sr, n_fft, n_mels, f_min,
                                              f_max, htk, norm), spec.device)


def _power_to_db(x, ref_value=1.0, amin=1e-10, top_db=None):
    db = 10.0 * torch.log10(torch.clamp(x, min=amin))
    db = db - 10.0 * math.log10(max(ref_value, amin))
    if top_db is not None:
        db = torch.maximum(db, db.max() - top_db)
    return db


def log_mel_spectrogram(waveforms, sr=16000, ref_value=1.0, amin=1e-10,
                        top_db=None, **mel_kwargs):
    """``paddle.audio.features.LogMelSpectrogram``."""
    mel_kwargs.setdefault("n_mels", 128)
    m = mel_spectrogram(waveforms, sr=sr, **mel_kwargs)
    return _power_to_db(m, ref_value, amin, top_db)


def mfcc(waveforms, sr=16000, n_mfcc=40, norm="ortho", ref_value=1.0,
         amin=1e-10, top_db=None, **mel_kwargs):
    """``paddle.audio.features.MFCC``: DCT-II of the log-mel dB."""
    assert norm == "ortho"
    mel_kwargs.setdefault("n_mels", 64)
    logmel = log_mel_spectrogram(waveforms, sr=sr, ref_value=ref_value,
                                 amin=amin, top_db=top_db, **mel_kwargs)
    return logmel @ kaldi._table(_dct_matrix_np(n_mfcc, logmel.shape[-1]),
                           logmel.device)


def fbank_dispatch(waveforms, sr=16000, n_mels=23, rng=None, **kwargs):
    """The Fbank route (JAX ``_fbank_dispatch``): the stock options at
    16 kHz go to ``fbank_fused``; anything else, dither included (which
    needs the ``torch.Generator`` ``rng``), to ``kaldi.fbank``."""
    missing = object()
    if sr == 16000 and all(kaldi.STOCK_OPTIONS.get(k, missing) == v
                           for k, v in kwargs.items()):
        return fbank_fused(waveforms, sr=sr, n_mels=n_mels)
    return kaldi.fbank(waveforms, sr=sr, n_mels=n_mels, rng=rng, **kwargs)


_METHODS = {
    "Fbank": (fbank_dispatch, dict(n_mels=23)),
    "MFCC": (mfcc, dict(n_mfcc=40)),
    "MelSpectrogram": (mel_spectrogram, dict(n_mels=64)),
    "LogMelSpectrogram": (log_mel_spectrogram, dict(n_mels=128)),
    "Spectrogram": (spectrogram, dict()),
}


def apply_cmn_and_mask(feature, input_lens_ratio=None):
    """Per-utterance CMN over time, then zero the padded tail.

    The valid count is ``floor(ratio * T)`` and the mean is taken over the
    valid frames only (JAX ``features.py:219-233``)."""
    t = feature.shape[1]
    if input_lens_ratio is None:
        return feature - feature.mean(dim=1, keepdim=True)
    ratio = torch.as_tensor(input_lens_ratio, dtype=torch.float32,
                            device=feature.device)
    lens = (ratio * t).to(torch.int32)
    mask = (torch.arange(t, device=feature.device)[None, :, None]
            < lens[:, None, None])
    denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1)
    mean = torch.where(mask, feature, 0.0).sum(dim=1, keepdim=True) / denom
    return torch.where(mask, feature - mean, 0.0)


def compute_feature(waveforms, feature_method="MelSpectrogram",
                    input_lens_ratio=None, rng=None, **method_args):
    """Padded waveforms ``(B, L)`` -> features ``(B, T, F)``. ``rng`` (a
    ``torch.Generator``) is consumed only by Fbank's ``dither``."""
    fn, defaults = _METHODS[feature_method]
    kwargs = dict(defaults)
    kwargs.update(method_args)
    if feature_method == "Fbank":
        kwargs["rng"] = rng
    return apply_cmn_and_mask(fn(waveforms, **kwargs), input_lens_ratio)


class AudioFeaturizer:
    """Batched featurizer (API of the JAX ``AudioFeaturizer``).

    ``__call__(waveforms, input_lens_ratio=None, rng=None)`` takes numpy
    arrays or tensors of shape ``(L,)`` or ``(B, L)`` and returns
    ``(B, T, F)`` on the tensor's device (numpy input runs on the CPU).
    With Fbank dither and no ``rng``, each call draws fresh noise, as
    kaldi's dither does."""

    def __init__(self, feature_method="MelSpectrogram", method_args=None):
        method_args = dict(method_args or {})
        if feature_method not in _METHODS:
            raise ValueError(f"unknown feature method: {feature_method}")
        method_args.setdefault("sr", 16000)
        self._feature_method = feature_method
        self._method_args = method_args
        self.dither = (float(method_args.get("dither", 0.0))
                       if feature_method == "Fbank" else 0.0)

    def __call__(self, waveforms, input_lens_ratio=None, rng=None):
        waveforms = torch.as_tensor(waveforms, dtype=torch.float32)
        if waveforms.ndim == 1:
            waveforms = waveforms[None]
        if self.dither > 0 and rng is None:
            rng = torch.Generator(device=waveforms.device)
            rng.manual_seed(int(np.random.randint(0, 2 ** 31)))
        return compute_feature(waveforms, self._feature_method,
                               input_lens_ratio=input_lens_ratio, rng=rng,
                               **self._method_args)

    @property
    def feature_dim(self):
        m, args = self._feature_method, self._method_args
        if m == "LogMelSpectrogram":
            return args.get("n_mels", 128)
        if m == "MelSpectrogram":
            return args.get("n_mels", 64)
        if m == "Spectrogram":
            return args.get("n_fft", 512) // 2 + 1
        if m == "MFCC":
            return args.get("n_mfcc", 40)
        # Fbank: use_energy adds the frame-energy column
        return args.get("n_mels", 23) + (1 if args.get("use_energy") else 0)

    @property
    def feature_method(self):
        return self._feature_method

    def num_frames(self, num_samples: int) -> int:
        """The frame count for ``num_samples`` valid samples."""
        a = self._method_args
        sr = a.get("sr", 16000)
        if self._feature_method == "Fbank":
            return kaldi.num_frames_kaldi(
                num_samples, int(sr * a.get("frame_length", 25.0) / 1000),
                int(sr * a.get("frame_shift", 10.0) / 1000),
                snip_edges=a.get("snip_edges", True))
        n_fft = a.get("n_fft", 512)
        win = a.get("win_length") or n_fft
        hop = a.get("hop_length") or win // 4
        return 1 + num_samples // hop
