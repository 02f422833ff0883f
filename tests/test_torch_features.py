"""PyTorch port, the feature front end beyond the stock Fbank: the four
other methods (MFCC, MelSpectrogram, LogMelSpectrogram, Spectrogram) and
the whole kaldi option surface (windows, centred frames, energy, VTLN,
``round_to_power_of_two``, ...) against the JAX ``compute_feature`` on the
same seeded waveforms, with length ratios; the Fbank route; dither.

Bars: log features (Fbank log-mel, LogMel dB, MFCC) as
``tests/test_torch_fbank.py``, max |d| < 2e-2 and 99th percentile < 1e-3;
linear features max |d| < 1e-4 of their largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voiceprintrecognition_paddlepaddle_torch.ops import features as tfeat
from voiceprintrecognition_paddlepaddle_torch.ops import kaldi as tkaldi
from voiceprintrecognition_paddlepaddle_tpu.ops import features as jfeat

RATIOS = np.asarray([1.0, 0.62, 0.3], np.float32)


def _waves(seed, b=3, n=16000):
    return (np.random.RandomState(seed).randn(b, n) * 0.1).astype(np.float32)


def _assert_bar(got, ref, log):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    d = np.abs(got - ref)
    if log:
        assert d.max() < 2e-2
        assert np.percentile(d, 99) < 1e-3
    else:
        assert d.max() < 1e-4 * np.abs(ref).max()


METHODS = [
    ("MFCC", {}, True), ("MFCC", dict(n_mfcc=20, n_mels=40), True),
    ("MelSpectrogram", {}, False),
    ("MelSpectrogram", dict(n_mels=80, win_length=400, hop_length=160,
                            window="hamming", f_max=7600.0), False),
    ("LogMelSpectrogram", {}, True),
    ("LogMelSpectrogram", dict(top_db=60.0, htk=True, norm=None), True),
    ("Spectrogram", {}, False),
    ("Spectrogram", dict(n_fft=400, power=2.0, center=False), False),
    ("Spectrogram", dict(pad_mode="constant", power=1.5), False),
]


@pytest.mark.parametrize(
    "method,args,log", METHODS,
    ids=[f"{m}-{i}" for i, (m, _, _) in enumerate(METHODS)])
def test_feature_method_matches_jax(method, args, log):
    w = _waves(1)
    ref = jfeat.compute_feature(w, method, input_lens_ratio=RATIOS,
                                sr=16000, **args)
    got = tfeat.compute_feature(torch.from_numpy(w), method,
                                input_lens_ratio=RATIOS, sr=16000, **args)
    _assert_bar(got, ref, log)
    jf, tf = (m.AudioFeaturizer(method, dict(args)) for m in (jfeat, tfeat))
    assert tf.feature_dim == jf.feature_dim == got.shape[-1]
    assert tf.num_frames(16000) == jf.num_frames(16000)


OPTIONS = [
    dict(window_type="hanning"), dict(window_type="hamming"),
    dict(window_type="rectangular"),
    dict(window_type="blackman", blackman_coeff=0.4),
    dict(snip_edges=False), dict(snip_edges=False, use_energy=True),
    dict(use_energy=True), dict(use_energy=True, raw_energy=False),
    dict(use_energy=True, htk_compat=True, energy_floor=0.0),
    dict(vtln_warp=0.9), dict(vtln_warp=1.1, vtln_low=200.0,
                              vtln_high=-800.0),
    dict(round_to_power_of_two=False), dict(use_power=False),
    dict(low_freq=60.0, high_freq=-400.0), dict(high_freq=7000.0),
    dict(preemphasis_coefficient=0.0, remove_dc_offset=False),
    dict(frame_length=32.0, frame_shift=12.0), dict(sr=8000),
]


@pytest.mark.parametrize("opts", OPTIONS,
                         ids=["-".join(f"{k}={v}" for k, v in o.items())
                              for o in OPTIONS])
def test_kaldi_options_match_jax(opts):
    w = _waves(2)
    args = {"sr": 16000, "n_mels": 40, **opts}
    ref = jfeat.compute_feature(w, "Fbank", input_lens_ratio=RATIOS, **args)
    got = tfeat.compute_feature(torch.from_numpy(w), "Fbank",
                                input_lens_ratio=RATIOS, **args)
    _assert_bar(got, ref, log=True)
    jf, tf = (m.AudioFeaturizer("Fbank", dict(args)) for m in (jfeat, tfeat))
    assert tf.feature_dim == jf.feature_dim == got.shape[-1]
    for n in (400, 16000, 16001):
        assert tf.num_frames(n) == jf.num_frames(n)
    assert tf.num_frames(w.shape[1]) == got.shape[1]


def test_linear_fbank_matches_jax():
    w = _waves(3)
    args = dict(sr=16000, n_mels=40, use_log_fbank=False)
    ref = jfeat.kaldi.fbank(w, **args)
    _assert_bar(tkaldi.fbank(torch.from_numpy(w), **args), ref, log=False)


@pytest.mark.parametrize("n,pad", [(1, 3), (2, 5), (5, 4), (5, 13),
                                   (300, 256), (1000, 256)])
def test_reflect_pad_is_numpys(n, pad):
    """The centred STFT pads as ``jnp.pad(mode="reflect")``, whose
    reflection repeats past the clip's length."""
    x = np.arange(n, dtype=np.float32)
    ref = np.asarray(jnp.pad(jnp.asarray(x), (pad, pad), mode="reflect"))
    np.testing.assert_array_equal(x[tfeat._reflect_index(n, pad)], ref)


def test_short_clip_spectrogram_matches_jax():
    w = _waves(4, b=2, n=200)
    _assert_bar(tfeat.spectrogram(torch.from_numpy(w)),
                jfeat.spectrogram(jnp.asarray(w)), log=False)


def test_fbank_route_follows_the_options(monkeypatch):
    """Stock options at 16 kHz go to ``fbank_fused`` (the kernel on a CUDA
    tensor), whether named or left out; anything else to ``kaldi.fbank``."""
    calls = []
    fused, plain = tfeat.fbank_fused, tkaldi.fbank
    monkeypatch.setattr(tfeat, "fbank_fused", lambda *a, **k: calls.append(
        "fused") or fused(*a, **k))
    monkeypatch.setattr(tkaldi, "fbank", lambda *a, **k: calls.append(
        "plain") or plain(*a, **k))
    w = torch.from_numpy(_waves(5, b=2))
    for opts, route in ((dict(), "fused"), (dict(dither=0.0), "fused"),
                        (dict(tkaldi.STOCK_OPTIONS), "fused"),
                        (dict(dither=1e-3), "plain"),
                        (dict(window_type="hamming"), "plain"),
                        (dict(sr=8000), "plain")):
        calls.clear()
        feat = tfeat.AudioFeaturizer("Fbank", {"n_mels": 80, **opts})
        out = feat(w, rng=torch.Generator().manual_seed(0))
        assert calls == [route], opts
        assert out.shape[-1] == 80


def test_dither_zero_is_the_undithered_path():
    w = torch.from_numpy(_waves(6, b=2))
    a = tkaldi.fbank(w, n_mels=40, dither=0.0,
                     rng=torch.Generator().manual_seed(0))
    b = tkaldi.fbank(w, n_mels=40)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    feat = tfeat.AudioFeaturizer("Fbank", {"n_mels": 80, "dither": 0.0})
    assert feat.dither == 0.0
    torch.testing.assert_close(
        feat(w), tfeat.AudioFeaturizer("Fbank", {"n_mels": 80})(w),
        rtol=0, atol=0)


def test_dither_from_a_fixed_generator_repeats():
    """Dither cannot match JAX's PRNG draws. A fixed generator gives the
    same features twice, another seed others; with no generator each call
    draws fresh noise, as kaldi's dither does. The noise moves the
    features as far as JAX's does: the mean |change| within 20 %."""
    w = torch.from_numpy(_waves(7, b=2))
    feat = tfeat.AudioFeaturizer("Fbank", {"n_mels": 40, "dither": 1e-2})

    def run(seed=None):
        rng = None if seed is None else torch.Generator().manual_seed(seed)
        return feat(w, input_lens_ratio=RATIOS[:2], rng=rng)

    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.equal(run(3), run(4))
    assert not torch.equal(run(), run())
    plain = tfeat.AudioFeaturizer("Fbank", {"n_mels": 40})(
        w, input_lens_ratio=RATIOS[:2])
    jf = jfeat.AudioFeaturizer("Fbank", {"n_mels": 40, "dither": 1e-2})
    ref = np.abs(np.asarray(jf(w.numpy(), RATIOS[:2], rng=jax.random.PRNGKey(
        3))) - np.asarray(jfeat.AudioFeaturizer("Fbank", {"n_mels": 40})(
            w.numpy(), RATIOS[:2]))).mean()
    assert 0.8 < float((run(3) - plain).abs().mean()) / ref < 1.25
