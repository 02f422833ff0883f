"""Kaldi-compatible Fbank in plain PyTorch, the whole option surface of the
JAX package's ``ops/kaldi.py``.

The numpy table builders (windows, the real-DFT basis, the mel banks with
kaldi's VTLN warp) are copies of the JAX module's. ``fbank`` computes, on
the tensor's device and in fp32, kaldi's steps as ``compute-fbank-feats``
orders them: framing (snip edges, or centred frames with reflected
edges), dither, DC removal, the raw frame energy, pre-emphasis with the
replicated first sample, the window, a real DFT as a product, the power
(or magnitude), the mel product, the log and the energy column.

``STOCK_OPTIONS`` are the defaults the fbank kernel computes
(``features.fbank_dispatch`` sends only those to it).
"""

import math
from functools import lru_cache

import numpy as np
import torch

__all__ = ["fbank", "frame_signal", "num_frames_snip_edges",
           "num_frames_kaldi", "STOCK_OPTIONS", "LOG_EPS"]

# float32 machine epsilon: kaldi floors mel energies here before the log
LOG_EPS = float(np.finfo(np.float32).eps)

# the kaldi options at the values the fbank kernel computes
STOCK_OPTIONS = dict(
    frame_length=25.0, frame_shift=10.0, dither=0.0, energy_floor=1.0,
    low_freq=20.0, high_freq=0.0, preemphasis_coefficient=0.97,
    remove_dc_offset=True, round_to_power_of_two=True, snip_edges=True,
    use_log_fbank=True, use_power=True, window_type="povey",
    blackman_coeff=0.42, use_energy=False, raw_energy=True, htk_compat=False,
    vtln_warp=1.0, vtln_low=100.0, vtln_high=-500.0)


def next_power_of_two(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def num_frames_snip_edges(num_samples: int, frame_len: int,
                          frame_shift: int) -> int:
    if num_samples < frame_len:
        return 0
    return 1 + (num_samples - frame_len) // frame_shift


def num_frames_kaldi(num_samples: int, frame_len: int, frame_shift: int,
                     snip_edges: bool = True) -> int:
    """Frame count for either edge mode (kaldi feature-window.h
    NumFrames)."""
    if snip_edges:
        return num_frames_snip_edges(num_samples, frame_len, frame_shift)
    return (num_samples + frame_shift // 2) // frame_shift


@lru_cache(maxsize=None)
def _window_np(window_type: str, n: int, blackman_coeff: float = 0.42):
    a = 2 * math.pi / (n - 1)
    k = np.arange(n, dtype=np.float64)
    if window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * k)) ** 0.85
    elif window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * k)
    elif window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * k)
    elif window_type == "rectangular":
        w = np.ones(n)
    elif window_type == "blackman":
        w = (blackman_coeff - 0.5 * np.cos(a * k)
             + (0.5 - blackman_coeff) * np.cos(2 * a * k))
    else:
        raise ValueError(f"unknown window type {window_type}")
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


def _inverse_mel_scale(mel):
    return 700.0 * (np.exp(mel / 1127.0) - 1.0)


def _vtln_warp_freq(vtln_low_cutoff, vtln_high_cutoff, low_freq, high_freq,
                    vtln_warp_factor, freq):
    """Kaldi's piecewise-linear VTLN frequency warp
    (mel-computations.cc VtlnWarpFreq): identity outside
    [low_freq, high_freq], slope 1/warp in the middle band, linear at the
    edges so that the endpoints are fixed."""
    assert vtln_low_cutoff > low_freq, \
        "vtln_low must be greater than low_freq"
    assert vtln_high_cutoff < high_freq, \
        "vtln_high (after +nyquist) must be less than high_freq"
    freq = np.asarray(freq, np.float64)
    lo = vtln_low_cutoff * max(1.0, vtln_warp_factor)
    hi = vtln_high_cutoff * min(1.0, vtln_warp_factor)
    assert lo > low_freq and hi < high_freq
    scale = 1.0 / vtln_warp_factor
    fl = scale * lo
    fh = scale * hi
    scale_left = (fl - low_freq) / (lo - low_freq)
    scale_right = (high_freq - fh) / (high_freq - hi)
    res = np.where(freq < hi, scale * freq,
                   high_freq + scale_right * (freq - high_freq))
    res = np.where(freq < lo, low_freq + scale_left * (freq - low_freq), res)
    return np.where((freq < low_freq) | (freq > high_freq), freq, res)


def _vtln_warp_mel(vtln_low, vtln_high, low_freq, high_freq, warp, mel):
    return _mel_scale(_vtln_warp_freq(vtln_low, vtln_high, low_freq,
                                      high_freq, warp,
                                      _inverse_mel_scale(mel)))


@lru_cache(maxsize=None)
def _kaldi_mel_banks_np(n_mels: int, n_fft: int, sample_rate: int,
                        low_freq: float = 20.0, high_freq: float = 0.0,
                        vtln_warp: float = 1.0, vtln_low: float = 100.0,
                        vtln_high: float = -500.0):
    """Kaldi mel filterbank over rfft bins, ``(n_fft//2+1, n_mels)``;
    the Nyquist row is zero. ``vtln_warp != 1`` warps each triangle's
    left / center / right mel points (mel-computations.cc MelBanks)."""
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
    if vtln_warp != 1.0:
        if vtln_high < 0.0:
            vtln_high += sample_rate / 2.0

        def warp(m):
            return _vtln_warp_mel(vtln_low, vtln_high, low_freq, high_freq,
                                  vtln_warp, m)
        left, center, right = warp(left), warp(center), warp(right)
    up = (bin_mels - left) / (center - left)
    down = (right - bin_mels) / (right - center)
    bank = np.maximum(0.0, np.minimum(up, down))
    bank = np.concatenate([bank, np.zeros((n_mels, 1))], axis=1)  # nyquist
    return bank.T.astype(np.float32)


def _table(array, device):
    return torch.from_numpy(array).to(device)


def frame_signal(waveforms, frame_len: int, frame_shift: int,
                 snip_edges: bool = True):
    """Strided framing ``(B, L) -> (B, T, frame_len)``.

    ``snip_edges=False`` centres a frame every ``frame_shift`` samples and
    reflects the signal at both edges, the edge sample repeated (kaldi
    feature-window.cc ExtractWindow)."""
    if not snip_edges:
        n = waveforms.shape[-1]
        m = num_frames_kaldi(n, frame_len, frame_shift, snip_edges=False)
        pad = frame_len // 2 - frame_shift // 2
        assert pad >= 0, "snip_edges=False requires frame_len >= frame_shift"
        need_right = (m - 1) * frame_shift + frame_len - pad - n
        assert 0 <= pad <= n and need_right <= n, \
            "clip too short for snip_edges=False framing"
        left = torch.flip(waveforms[..., :pad], dims=(-1,))
        right = torch.flip(waveforms, dims=(-1,))[..., :max(need_right, 0)]
        waveforms = torch.cat([left, waveforms, right], dim=-1)
        waveforms = waveforms[..., :(m - 1) * frame_shift + frame_len]
    t = num_frames_snip_edges(waveforms.shape[-1], frame_len, frame_shift)
    if t == 0:
        return waveforms.new_zeros(*waveforms.shape[:-1], 0, frame_len)
    return waveforms[..., :(t - 1) * frame_shift + frame_len].unfold(
        -1, frame_len, frame_shift)


def fbank(waveforms, sr: int = 16000, n_mels: int = 23,
          frame_length: float = 25.0, frame_shift: float = 10.0,
          dither: float = 0.0, energy_floor: float = 1.0,
          low_freq: float = 20.0, high_freq: float = 0.0,
          preemphasis_coefficient: float = 0.97,
          remove_dc_offset: bool = True, round_to_power_of_two: bool = True,
          snip_edges: bool = True, use_log_fbank: bool = True,
          use_power: bool = True, window_type: str = "povey",
          blackman_coeff: float = 0.42, use_energy: bool = False,
          raw_energy: bool = True, htk_compat: bool = False,
          vtln_warp: float = 1.0, vtln_low: float = 100.0,
          vtln_high: float = -500.0, rng=None):
    """Batched kaldi fbank ``(B, L) -> (B, T, n_mels)`` (``n_mels + 1``
    with ``use_energy``) in plain fp32 torch, on the tensor's device.

    Defaults are kaldi's ``compute-fbank-feats`` as paddleaudio sets them.
    Dither adds ``dither * N(0, 1)`` noise drawn from ``rng``, a
    ``torch.Generator`` on the tensor's device, which it requires."""
    x = torch.as_tensor(waveforms, dtype=torch.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    frame_len = int(sr * frame_length / 1000.0)
    shift = int(sr * frame_shift / 1000.0)
    n_fft = next_power_of_two(frame_len) if round_to_power_of_two \
        else frame_len

    frames = frame_signal(x, frame_len, shift, snip_edges=snip_edges)
    if dither != 0.0:
        if rng is None:
            raise ValueError("dither > 0 requires a torch.Generator (rng)")
        frames = frames + dither * torch.randn(
            frames.shape, generator=rng, device=frames.device)
    if remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)

    def log_energy(f):
        e = torch.log(torch.clamp((f * f).sum(dim=-1), min=LOG_EPS))
        if energy_floor > 0.0:
            e = torch.clamp(e, min=math.log(energy_floor))
        return e

    energy = log_energy(frames) if (use_energy and raw_energy) else None
    if preemphasis_coefficient != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemphasis_coefficient * prev
    frames = frames * _table(_window_np(window_type, frame_len,
                                        blackman_coeff), x.device)
    if use_energy and not raw_energy:
        energy = log_energy(frames)

    spec = frames @ _table(_rdft_np(frame_len, n_fft), x.device)
    n_bins = n_fft // 2 + 1
    power = spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2
    if not use_power:
        power = torch.sqrt(power)
    feats = power @ _table(_kaldi_mel_banks_np(
        n_mels, n_fft, sr, low_freq, high_freq, vtln_warp, vtln_low,
        vtln_high), x.device)
    if use_log_fbank:
        feats = torch.log(torch.clamp(feats, min=LOG_EPS))
    if use_energy:
        # htk_compat appends the energy column, kaldi prepends it
        cols = ([feats, energy[..., None]] if htk_compat
                else [energy[..., None], feats])
        feats = torch.cat(cols, dim=-1)
    return feats[0] if squeeze else feats
