"""Audio feature front end: Fbank with per-utterance CMN and tail masking.

Counterpart of the JAX package's ``ops/features.py`` for the slice the
port serves: ``feature_method="Fbank"`` with the stock kaldi options.
Fbank runs through ``fbank_kernel.fbank_fused`` (the CUDA kernel on a
CUDA tensor). The other feature methods, dither and non-stock kaldi
options raise ``NotImplementedError``; they are queued in ROADMAP.md.
The default method is the JAX package's, ``"MelSpectrogram"``, so a call
that names no method raises until that method is ported.

Output convention as in the JAX package: ``(B, T, F)``, CMN over the
valid frames only when length ratios are given.
"""

import torch

from . import kaldi
from .fbank_kernel import fbank_fused

__all__ = ["AudioFeaturizer", "compute_feature", "apply_cmn_and_mask"]


def _check_method(feature_method, method_args):
    if feature_method != "Fbank":
        raise NotImplementedError(
            f"feature method {feature_method!r} is not ported yet (Fbank "
            "only); see ROADMAP.md queue 1")
    kaldi.check_stock_options(
        {k: v for k, v in method_args.items() if k not in ("sr", "n_mels")})


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
                    input_lens_ratio=None, sr=16000, n_mels=23,
                    **method_args):
    """Padded waveforms ``(B, L)`` -> features ``(B, T, n_mels)``."""
    _check_method(feature_method, method_args)
    feature = fbank_fused(waveforms, sr=sr, n_mels=n_mels)
    return apply_cmn_and_mask(feature, input_lens_ratio)


class AudioFeaturizer:
    """Batched featurizer (API of the JAX ``AudioFeaturizer``).

    ``__call__(waveforms, input_lens_ratio=None)`` takes numpy arrays or
    tensors of shape ``(L,)`` or ``(B, L)`` and returns ``(B, T, F)`` on
    the tensor's device (numpy input runs on the CPU)."""

    def __init__(self, feature_method="MelSpectrogram", method_args=None):
        method_args = dict(method_args or {})
        method_args.setdefault("sr", 16000)
        _check_method(feature_method, method_args)
        self._feature_method = feature_method
        self._method_args = method_args

    def __call__(self, waveforms, input_lens_ratio=None):
        waveforms = torch.as_tensor(waveforms, dtype=torch.float32)
        if waveforms.ndim == 1:
            waveforms = waveforms[None]
        return compute_feature(waveforms, self._feature_method,
                               input_lens_ratio=input_lens_ratio,
                               **self._method_args)

    @property
    def feature_dim(self):
        return self._method_args.get("n_mels", 23)

    @property
    def feature_method(self):
        return self._feature_method

    def num_frames(self, num_samples: int) -> int:
        """Frame count for ``num_samples`` valid samples."""
        sr = self._method_args["sr"]
        return kaldi.num_frames_snip_edges(
            num_samples, int(sr * 25.0 / 1000), int(sr * 10.0 / 1000))
