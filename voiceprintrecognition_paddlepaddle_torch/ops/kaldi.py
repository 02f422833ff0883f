"""Kaldi-compatible Fbank in plain PyTorch, for the stock options.

The numpy table builders are copies of the JAX package's ``ops/kaldi.py``
(``_window_np`` for the povey window, ``_rdft_np``, ``_kaldi_mel_banks_np``
without VTLN).
``fbank`` covers the options the CAM++ configs use: 25/10 ms frames,
povey window, pre-emphasis 0.97, DC removal, power spectrum, 20 Hz to
Nyquist, snip edges, no dither. Any other option raises
``NotImplementedError``: the rest of the surface is queued in ROADMAP.md.
"""

import math
from functools import lru_cache

import numpy as np
import torch

__all__ = ["fbank", "num_frames_snip_edges", "num_frames_kaldi",
           "check_stock_options", "STOCK_OPTIONS"]

# float32 machine epsilon: kaldi floors mel energies here before the log
LOG_EPS = float(np.finfo(np.float32).eps)

# the kaldi options this slice implements, at their only supported value
STOCK_OPTIONS = dict(
    frame_length=25.0, frame_shift=10.0, dither=0.0, energy_floor=1.0,
    low_freq=20.0, high_freq=0.0, preemphasis_coefficient=0.97,
    remove_dc_offset=True, round_to_power_of_two=True, snip_edges=True,
    use_log_fbank=True, use_power=True, window_type="povey",
    use_energy=False, raw_energy=True, htk_compat=False, vtln_warp=1.0)


def check_stock_options(options):
    """Raise ``NotImplementedError`` for any kaldi option this slice does
    not implement (an unknown key, or a known key at another value)."""
    for k, v in options.items():
        if k not in STOCK_OPTIONS or v != STOCK_OPTIONS[k]:
            raise NotImplementedError(
                f"Fbank option {k}={v!r} is not ported yet (only the stock "
                "options are); see ROADMAP.md queue 1")


def next_power_of_two(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def num_frames_snip_edges(num_samples: int, frame_len: int,
                          frame_shift: int) -> int:
    if num_samples < frame_len:
        return 0
    return 1 + (num_samples - frame_len) // frame_shift


def num_frames_kaldi(num_samples: int, frame_len: int, frame_shift: int,
                     snip_edges: bool = True) -> int:
    """Frame count for either edge mode (kaldi feature-window.h)."""
    if snip_edges:
        return num_frames_snip_edges(num_samples, frame_len, frame_shift)
    return (num_samples + frame_shift // 2) // frame_shift


@lru_cache(maxsize=None)
def _window_np(window_type: str, n: int):
    if window_type != "povey":
        raise NotImplementedError(f"window {window_type!r} is not ported yet; "
                                  "see ROADMAP.md queue 1")
    k = np.arange(n, dtype=np.float64)
    w = (0.5 - 0.5 * np.cos(2 * math.pi / (n - 1) * k)) ** 0.85
    return w.astype(np.float32)


@lru_cache(maxsize=None)
def _rdft_np(frame_len: int, n_fft: int):
    """Real-DFT basis ``(frame_len, 2*n_bins)``, columns [cos | -sin]:
    ``frames @ basis`` equals zero-padding to ``n_fft`` and an rfft."""
    n_bins = n_fft // 2 + 1
    j = np.arange(frame_len)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2 * math.pi * j * k / n_fft
    mat = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1)
    return mat.astype(np.float32)


def _mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


@lru_cache(maxsize=None)
def _kaldi_mel_banks_np(n_mels: int, n_fft: int, sample_rate: int,
                        low_freq: float = 20.0, high_freq: float = 0.0):
    """Kaldi mel filterbank over rfft bins, ``(n_fft//2+1, n_mels)``;
    the Nyquist row is zero."""
    if high_freq <= 0.0:
        high_freq = sample_rate / 2.0 + high_freq
    assert 0.0 <= low_freq < high_freq <= sample_rate / 2.0
    n_bins = n_fft // 2
    fft_bin_width = sample_rate / n_fft
    mel_low = _mel_scale(low_freq)
    mel_high = _mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (n_mels + 1)

    bin_mels = _mel_scale(fft_bin_width * np.arange(n_bins))[None, :]
    left = mel_low + np.arange(n_mels)[:, None] * mel_delta
    center = left + mel_delta
    right = center + mel_delta
    up = (bin_mels - left) / (center - left)
    down = (right - bin_mels) / (right - center)
    bank = np.maximum(0.0, np.minimum(up, down))
    bank = np.concatenate([bank, np.zeros((n_mels, 1))], axis=1)  # nyquist
    return bank.T.astype(np.float32)


def fbank(waveforms, sr: int = 16000, n_mels: int = 23, **options):
    """Batched kaldi fbank ``(B, L) -> (B, T, n_mels)`` in plain fp32
    torch, on the tensor's device, step by step as kaldi computes it
    (framing, DC removal, pre-emphasis with the replicated first sample,
    window, real DFT, power, mel, log)."""
    check_stock_options(options)
    x = torch.as_tensor(waveforms, dtype=torch.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    frame_len = int(sr * STOCK_OPTIONS["frame_length"] / 1000.0)
    shift = int(sr * STOCK_OPTIONS["frame_shift"] / 1000.0)
    n_fft = next_power_of_two(frame_len)
    t = num_frames_snip_edges(x.shape[-1], frame_len, shift)
    frames = x[:, :(t - 1) * shift + frame_len].unfold(-1, frame_len, shift)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - STOCK_OPTIONS["preemphasis_coefficient"] * prev
    frames = frames * torch.from_numpy(
        _window_np("povey", frame_len)).to(x.device)
    rdft = torch.from_numpy(_rdft_np(frame_len, n_fft)).to(x.device)
    spec = frames @ rdft
    n_bins = n_fft // 2 + 1
    power = spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2
    mel = torch.from_numpy(_kaldi_mel_banks_np(n_mels, n_fft, sr)).to(x.device)
    feats = torch.log(torch.clamp(power @ mel, min=LOG_EPS))
    return feats[0] if squeeze else feats
