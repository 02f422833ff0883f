"""Batch collation with bucketed lengths (copy of the JAX package's
``data_utils/collate.py``).

Eval batches pad to a small set of lengths so that the embed path sees a
handful of shapes; the padding is masked on the device. Train batches are
already fixed-length crops."""

import math

import numpy as np

__all__ = ["collate_waveforms", "collate_features", "bucket_length"]


def bucket_length(n, minimum=16000, factor=2.0):
    """Smallest bucket >= n from a x``factor`` progression starting at
    ``minimum``."""
    if n <= minimum:
        return minimum
    steps = math.ceil(math.log(n / minimum) / math.log(factor) - 1e-9)
    return int(round(minimum * factor ** steps))


def collate_waveforms(batch, bucket=True, quantize_int16=False):
    """``[(wave (L,), label, valid), ...]`` ->
    (waves (B, Lb), labels (B,), lens_ratio (B,)).

    ``quantize_int16`` ships the batch as int16 (the precision of the PCM
    sources) and halves the host-to-device bytes; the train step converts
    back to float on the device."""
    max_len = max(item[0].shape[0] for item in batch)
    if bucket:
        max_len = bucket_length(max_len)
    b = len(batch)
    dtype = np.int16 if quantize_int16 else np.float32
    waves = np.zeros((b, max_len), dtype=dtype)
    labels = np.empty((b,), dtype=np.int64)
    ratios = np.empty((b,), dtype=np.float32)
    for i, (w, label, valid) in enumerate(batch):
        if quantize_int16 and w.dtype != np.int16:
            w = (np.clip(w, -1.0, 1.0) * 32767.0).astype(np.int16)
        elif not quantize_int16 and w.dtype == np.int16:
            w = w.astype(np.float32) / 32768.0
        waves[i, :w.shape[0]] = w
        labels[i] = label
        ratios[i] = min(valid, max_len) / max_len
    return waves, labels, ratios


def collate_features(batch, bucket=True):
    """``[(feature (T, F), label, valid_T), ...]`` ->
    (features (B, Tb, F), labels, lens_ratio), bucketed from 128 frames."""
    max_t = max(item[0].shape[0] for item in batch)
    if bucket:
        max_t = bucket_length(max_t, minimum=128)
    f = batch[0][0].shape[1]
    b = len(batch)
    feats = np.zeros((b, max_t, f), dtype=np.float32)
    labels = np.empty((b,), dtype=np.int64)
    ratios = np.empty((b,), dtype=np.float32)
    for i, (x, label, valid) in enumerate(batch):
        feats[i, :x.shape[0]] = x
        labels[i] = label
        ratios[i] = min(valid, max_t) / max_t
    return feats, labels, ratios
