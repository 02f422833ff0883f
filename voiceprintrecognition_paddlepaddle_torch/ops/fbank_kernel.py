"""Fused Kaldi fbank straight from the waveform: the counterpart of the
JAX package's ``ops/pallas_fbank.py``.

``fbank_fused`` launches the CUDA kernel ``csrc/fbank.cu`` on a CUDA
tensor: per frame, in fp32 and in kaldi's order, DC removal,
pre-emphasis (with kaldi's replicated first sample), the povey window,
a 512-point real FFT (a packed 256-point complex FFT and its split),
the power of bins 0..255 (the Nyquist bin's mel weight is 0), each mel
filter's nonzero weights and the log. The host builds its tables
(``fbank_tables``): the window, the twiddles W_512^k in float64 rounded to
fp32, and the mel weights packed per filter.

On a CPU tensor it runs ``fbank_fused_reference``, the plain version: DC
removal, pre-emphasis and the window fold into one ``(400, 512)`` DFT
matrix (``folded_dft_np``, cos | sin, Nyquist dropped), so

    spec[t] = wave[160 t : 160 t + 400] @ Bfold
    out[t]  = log(max((re^2 + im^2) @ mel, FLT_EPSILON))

in plain fp32 torch: a formulation independent of the kernel's FFT. It
never falls back from CUDA to the plain version. CMN stays outside, in
``features.apply_cmn_and_mask``.
"""

import ctypes
from collections import namedtuple
from functools import lru_cache

import numpy as np
import torch

from . import kaldi

__all__ = ["folded_dft_np", "FbankTables", "fbank_fused",
           "fbank_fused_reference", "fbank_tables"]

_FRAME_LEN, _SHIFT, _N_FFT = 400, 160, 512   # 25/10 ms at 16 kHz


def folded_dft_np(frame_len, n_fft, preemph=0.97):
    """DFT matrix with DC removal, pre-emphasis and the povey window folded
    in (copy of ``pallas_fbank._folded_dft_np``).

    Returns ``B: (frame_len, 2*(n_fft//2))`` float64 (Nyquist dropped)
    such that ``frame @ B`` equals window(preemph(dc_remove(frame))) @ rdft.
    """
    n_bins = n_fft // 2 + 1
    keep = n_bins - 1
    rdft = kaldi._rdft_np(frame_len, n_fft)
    rdft = np.concatenate(
        [rdft[:, :keep], rdft[:, n_bins:n_bins + keep]], axis=1)
    window = kaldi._window_np("povey", frame_len).astype(np.float64)
    wp = window[:, None] * rdft.astype(np.float64)
    c = np.zeros_like(wp)
    # y[j] = (x[j]-mu) - p*(x[j-1]-mu) for j>=1;  y[0] = (1-p)*(x[0]-mu)
    c[1:] += wp[1:]
    c[:-1] -= preemph * wp[1:]
    c[0] += (1.0 - preemph) * wp[0]
    s = (1.0 - preemph) * wp[1:].sum(axis=0) + (1.0 - preemph) * wp[0]
    c -= s[None, :] / frame_len
    return c


# bfold, mel: the plain version's; window, twiddles, mel_packed, mel_range:
# the kernel's
FbankTables = namedtuple(
    "FbankTables", "bfold mel window twiddles mel_packed mel_range")


@lru_cache(maxsize=None)
def _tables_np(sr, n_mels):
    if sr != 16000:
        raise ValueError(
            f"the fbank kernel frames 16 kHz audio only, got sr={sr}; "
            "features.fbank_dispatch sends other rates to kaldi.fbank")
    bfold = folded_dft_np(_FRAME_LEN, _N_FFT).astype(np.float32)
    mel = kaldi._kaldi_mel_banks_np(n_mels, _N_FFT, sr)
    keep = _N_FFT // 2
    if not np.all(mel[keep] == 0.0):
        raise ValueError("Nyquist bin carries mel weight; it cannot be "
                         "dropped from the folded DFT")
    mel = np.ascontiguousarray(mel[:keep])
    # [first, last + 1) nonzero bin of each filter, and its weights from
    # column 0, zero-padded to a multiple of 4 bins (the kernel's 16-byte
    # steps), for the kernel's sparse mel product (the weights outside are
    # exactly 0)
    rng = np.zeros((n_mels, 2), np.int32)
    for m in range(n_mels):
        nz = np.flatnonzero(mel[:, m])
        if nz.size:
            rng[m] = nz[0], nz[-1] + 1
    width = max(1, int(np.max(rng[:, 1] - rng[:, 0])))
    packed = np.zeros((n_mels, -(-width // 4) * 4), np.float32)
    for m, (lo, hi) in enumerate(rng):
        packed[m, :hi - lo] = mel[lo:hi, m]
    # W_512^k = (cos, -sin)(2 pi k / 512), in float64, rounded once
    ang = 2.0 * np.pi * np.arange(_N_FFT, dtype=np.float64) / _N_FFT
    twiddles = np.stack([np.cos(ang), -np.sin(ang)], 1).astype(np.float32)
    return FbankTables(bfold, mel, kaldi._window_np("povey", _FRAME_LEN),
                       twiddles, packed, rng)


@lru_cache(maxsize=None)
def fbank_tables(sr, n_mels, device):
    """``FbankTables`` on ``device``, built once per process: Bfold
    (400, 512) and mel (256, n_mels) for the plain version; window (400,),
    twiddles (512, 2), mel_packed (n_mels, widest filter rounded up to
    4 bins) fp32 and mel_range (n_mels, 2) int32 for the kernel."""
    return FbankTables(*(torch.from_numpy(a).to(device)
                         for a in _tables_np(sr, n_mels)))


def _num_frames(num_samples):
    t = kaldi.num_frames_snip_edges(num_samples, _FRAME_LEN, _SHIFT)
    if t < 1:
        raise ValueError(f"{num_samples} samples hold no 25 ms frame")
    return t


def fbank_fused_reference(waves, sr=16000, n_mels=80):
    """Plain fp32 torch version of the kernel: ``(B, L) -> (B, T, n_mels)``
    raw log-mel."""
    tables = fbank_tables(sr, n_mels, waves.device)
    bfold, mel = tables.bfold, tables.mel
    t = _num_frames(waves.shape[-1])
    frames = waves[:, :(t - 1) * _SHIFT + _FRAME_LEN].unfold(
        -1, _FRAME_LEN, _SHIFT)
    spec = frames @ bfold
    keep = _N_FFT // 2
    power = spec[..., :keep] ** 2 + spec[..., keep:] ** 2
    return torch.log(torch.clamp(power @ mel, min=kaldi.LOG_EPS))


@lru_cache(maxsize=None)
def _entry():
    from .._build import kernel_library
    fn = kernel_library().lib.vpr_fbank
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    return fn


def fbank_fused(waves, sr=16000, n_mels=80):
    """Raw log-mel ``(B, T, n_mels)`` float32 from waveforms ``(B, L)``.

    A CPU tensor runs the plain version. A CUDA tensor launches the CUDA
    kernel and adds one to ``fbank_fused.launches``."""
    if waves.ndim != 2:
        raise ValueError(f"expected (B, L) waveforms, got {tuple(waves.shape)}")
    waves = waves.to(torch.float32)
    if waves.device.type == "cpu":
        return fbank_fused_reference(waves, sr, n_mels)
    if waves.device.type != "cuda":
        raise ValueError(f"unsupported device {waves.device}")
    if n_mels > 256:
        raise ValueError(f"n_mels={n_mels} exceeds the kernel's 256")
    waves = waves.contiguous()
    b, length = waves.shape
    t = _num_frames(length)
    tables = fbank_tables(sr, n_mels, waves.device)
    out = torch.empty((b, t, n_mels), dtype=torch.float32,
                      device=waves.device)
    from .._build import check
    err = _entry()(waves.data_ptr(), tables.window.data_ptr(),
                   tables.twiddles.data_ptr(), tables.mel_packed.data_ptr(),
                   tables.mel_range.data_ptr(), out.data_ptr(), b, length, t,
                   n_mels, tables.mel_packed.shape[1],
                   torch.cuda.current_stream(waves.device).cuda_stream)
    check(err, "vpr_fbank")
    fbank_fused.launches += 1
    return out


fbank_fused.launches = 0
