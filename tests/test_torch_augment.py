"""PyTorch port, augmentation (``ops/augment.py``) against the JAX
package's: the deterministic pieces on the same seeded inputs (volume,
noise mixing at given SNRs, reverb, dB normalization with padded tails,
SpecAugment masks and time warping with the draws JAX makes from its key,
fed to the port's ``spec_masks`` / ``warp_time``); speed perturbation and
the audio bank (host code, copied) bit for bit; and the draws of the
port's ``DeviceAugmenter`` and ``spec_augment`` from a ``torch.Generator``
statistically at b 2000 (probabilities and ranges).

Bar: 1e-5 of each output's largest entry for the tensor pieces.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_native import require_jax_native
from voiceprintrecognition_paddlepaddle_torch.ops import augment as ta
from voiceprintrecognition_paddlepaddle_tpu.ops import augment as ja

from torch_card import write_wav


def _close(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def _waves(b=4, n=4000, seed=0):
    rng = np.random.RandomState(seed)
    w = (rng.randn(b, n) * rng.uniform(0.01, 0.5, (b, 1))).astype(np.float32)
    ratio = np.asarray([1.0, 0.75, 0.5, 0.3][:b], np.float32)
    for i, r in enumerate(ratio):
        w[i, int(r * n):] = 0.0
    return w, ratio


def test_volume_noise_and_normalize_match_jax():
    w, ratio = _waves()
    rng = np.random.RandomState(1)
    gain = rng.uniform(-15, 15, 4).astype(np.float32)
    noise = (rng.randn(4, 4000) * 0.2).astype(np.float32)
    snr = rng.uniform(10, 50, 4).astype(np.float32)
    tw, tr = torch.from_numpy(w), torch.from_numpy(ratio)
    _close(ja.apply_volume(jnp.asarray(w), jnp.asarray(gain)),
           ta.apply_volume(tw, torch.from_numpy(gain)))
    _close(ja.mix_noise(jnp.asarray(w), jnp.asarray(noise), jnp.asarray(snr),
                        jnp.asarray(ratio)),
           ta.mix_noise(tw, torch.from_numpy(noise), torch.from_numpy(snr),
                        tr))
    for r, tr_ in ((None, None), (jnp.asarray(ratio), tr)):
        _close(ja.normalize_db(jnp.asarray(w), -20.0, valid_ratio=r),
               ta.normalize_db(tw, -20.0, valid_ratio=tr_))
        _close(ja.rms_db(jnp.asarray(w), valid_ratio=r),
               ta.rms_db(tw, valid_ratio=tr_))


@pytest.mark.parametrize("rir_len", [160, 800, 4000])
def test_reverb_matches_jax(rir_len):
    w, _ = _waves()
    rng = np.random.RandomState(2)
    rir = (rng.randn(4, rir_len) * np.exp(-np.arange(rir_len) / 100.0)
           ).astype(np.float32)
    _close(ja.apply_reverb(jnp.asarray(w), jnp.asarray(rir)),
           ta.apply_reverb(torch.from_numpy(w), torch.from_numpy(rir)))


def _feats(b=6, t=120, f=40, seed=3):
    return np.random.RandomState(seed).randn(b, t, f).astype(np.float32)


@pytest.mark.parametrize("w", [3, 5, 10])
def test_time_warp_with_jax_draws_matches_jax(w):
    x = _feats()
    b, t, _ = x.shape
    key = jax.random.PRNGKey(w)
    ref = ja.time_warp(jnp.asarray(x), key, max_time_warp=w)
    # the draws JAX's time_warp makes from its key
    k1, k2 = jax.random.split(key)
    center = jax.random.randint(k1, (b,), w, t - w)
    dest = center + jax.random.randint(k2, (b,), -w, w + 1)
    got = ta.warp_time(torch.from_numpy(x), torch.from_numpy(
        np.asarray(center)), torch.from_numpy(np.asarray(dest)))
    _close(ref, got)


@pytest.mark.parametrize("n_masks,warp", [(1, 0), (2, 0), (2, 5)])
def test_spec_augment_with_jax_masks_matches_jax(n_masks, warp):
    x = _feats()
    b, t, f = x.shape
    key = jax.random.PRNGKey(7 + n_masks + warp)
    kw = dict(freq_mask_ratio=0.1, n_freq_masks=n_masks,
              time_mask_ratio=0.05, n_time_masks=n_masks, prob=0.6,
              max_time_warp=warp)
    ref = ja.spec_augment(jnp.asarray(x), key, **kw)
    keys = jax.random.split(key, 5)
    f_width, t_width = max(int(f * 0.1), 1), max(int(t * 0.05), 1)
    apply = np.asarray(jax.random.uniform(keys[0], (b, 1, 1)) < 0.6)
    t_starts = jax.random.randint(keys[1], (b, n_masks), 0,
                                  max(t - t_width, 1))
    f_starts = jax.random.randint(keys[2], (b, n_masks), 0,
                                  max(f - f_width, 1))
    feats = torch.from_numpy(x)
    if warp:
        k1, k2 = jax.random.split(keys[3])
        center = jax.random.randint(k1, (b,), warp, t - warp)
        dest = center + jax.random.randint(k2, (b,), -warp, warp + 1)
        warped = ta.warp_time(feats, torch.from_numpy(np.asarray(center)),
                              torch.from_numpy(np.asarray(dest)))
        feats = torch.where(torch.from_numpy(apply), warped, feats)
    masked = ta.spec_masks(feats, torch.from_numpy(np.asarray(t_starts)),
                           torch.from_numpy(np.asarray(f_starts)), t_width,
                           f_width)
    got = torch.where(torch.from_numpy(apply), masked, feats)
    _close(ref, got)


def test_spec_augment_draws_from_a_generator():
    """b 2000: the share of masked rows is ``prob``, each masked row loses
    one time band of ``int(0.05 T)`` frames and one band of ``int(0.1 F)``
    bins that start uniformly in range; the same seed gives the same
    result."""
    b, t, f = 2000, 100, 40
    x = torch.ones(b, t, f)
    gen = torch.Generator().manual_seed(0)
    out = ta.spec_augment(x, gen, prob=0.5)
    hit = (out == 0).flatten(1).any(1).numpy()
    assert abs(hit.mean() - 0.5) < 4 * np.sqrt(0.25 / b)
    zero_t = (out[hit] == 0).all(2).sum(1).numpy()   # fully zero frames
    zero_f = (out[hit] == 0).all(1).sum(1).numpy()   # fully zero bins
    assert (zero_t == 5).all() and (zero_f == 4).all()
    starts = np.argmax((out[hit] == 0).all(2).numpy(), axis=1)
    assert starts.min() == 0 and starts.max() == t - 5 - 1
    assert abs(starts.mean() - (t - 5 - 1) / 2) < 3
    again = ta.spec_augment(x, torch.Generator().manual_seed(0), prob=0.5)
    assert torch.equal(out, again)


def test_device_augmenter_draws_from_a_generator(tmp_path):
    """b 2000 with volume (prob 0.3, -15..15 dB), noise (prob 0.4, SNR
    10..50 dB) and the dB normalization: the share of rows each augment
    touched and the ranges of the gains it drew."""
    noise_dir = tmp_path / "noise"
    noise_dir.mkdir()
    rng = np.random.RandomState(4)
    for i in range(3):
        write_wav(noise_dir / f"n{i}.wav", rng.randn(8000) * 0.1)
    b, n = 2000, 1600
    waves = torch.from_numpy(
        (rng.randn(1, n) * 0.1).astype(np.float32)).repeat(b, 1)
    conf = {"volume": {"prob": 0.3, "min_gain_dBFS": -15,
                       "max_gain_dBFS": 15}}
    aug = ta.DeviceAugmenter(conf, 16000, 0.1, target_db=None)
    out = aug(waves, torch.Generator().manual_seed(1))
    gain = (ta.rms_db(out) - ta.rms_db(waves)).numpy()
    on = np.abs(gain) > 1e-3
    assert abs(on.mean() - 0.3) < 4 * np.sqrt(0.21 / b)
    assert gain[on].min() > -15.01 and gain[on].max() < 15.01
    assert abs(gain[on].mean()) < 1.5
    conf = {"noise": {"prob": 0.4, "noise_dir": str(noise_dir),
                      "min_snr_dB": 10, "max_snr_dB": 50}}
    aug = ta.DeviceAugmenter(conf, 16000, 0.1, target_db=-20)
    out = aug(waves, torch.Generator().manual_seed(2))
    added = out - ta.normalize_db(waves, -20.0)
    on = (added.abs().amax(1) > 1e-6).numpy()
    assert abs(on.mean() - 0.4) < 4 * np.sqrt(0.24 / b)
    # every row ends at the target level after the augments
    np.testing.assert_allclose(ta.rms_db(out).numpy(), -20.0, atol=1e-3)
    clean = ta.normalize_db(waves, -20.0)[on]
    noise = out[on] - clean
    snr = (ta.rms_db(clean) - ta.rms_db(noise)).numpy()
    assert snr.min() > 9.0 and snr.max() < 51.0


def test_speed_perturb_and_audio_bank_match_jax(tmp_path):
    require_jax_native()
    x = (np.random.RandomState(5).randn(16000) * 0.1).astype(np.float32)
    for speed in (0.9, 1.1):
        np.testing.assert_array_equal(
            ta.SpeedPerturbAugmentor.resample(x, speed),
            ja.SpeedPerturbAugmentor.resample(x, speed))
    kw = dict(prob=0.7, speed_perturb_3_class=True, num_speakers=4)
    tp, jp = ta.SpeedPerturbAugmentor(**kw), ja.SpeedPerturbAugmentor(**kw)
    r1, r2 = random.Random(3), random.Random(3)
    for spk in range(50):
        a, la = tp(x[:800], spk % 4, r1)
        b, lb = jp(x[:800], spk % 4, r2)
        assert la == lb
        np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(6)
    for i, sec in enumerate((0.05, 0.2, 0.5)):
        write_wav(tmp_path / f"c{i}.wav", rng.randn(int(sec * 16000)) * 0.1)
    for mode in ("tile", "zero"):
        tb = ta.AudioBank(str(tmp_path), 16000, 0.1, max_clips=2,
                          pad_mode=mode)
        jb = ja.AudioBank(str(tmp_path), 16000, 0.1, max_clips=2,
                          pad_mode=mode)
        for epoch in (0, 1, 2):
            np.testing.assert_array_equal(tb.bank(epoch).numpy(),
                                          np.asarray(jb.bank(epoch)))
