"""PyTorch port, fbank front end: the plain torch fbank and the fused
kernel's plain version against the JAX ``kaldi.fbank`` and the Pallas
kernel (interpret mode), and the CMN'd features against
``compute_feature``. The CUDA kernel itself is held against its plain
version in ``test_torch_gpu.py``.

Bars (``tests/test_pallas_fbank.py:23-25``): max |d| < 2e-2 and 99th
percentile < 1e-3 on raw log-mel; < 2e-3 on the CMN'd features.
"""

import numpy as np
import pytest
import torch

from chip_smoke import fbank_steps, tone_then_silence
from voiceprintrecognition_paddlepaddle_torch.ops import fbank_kernel
from voiceprintrecognition_paddlepaddle_torch.ops import features as tfeat
from voiceprintrecognition_paddlepaddle_torch.ops import kaldi as tkaldi
from voiceprintrecognition_paddlepaddle_torch.ops.fbank_kernel import (
    fbank_fused, fbank_fused_reference, fbank_tables, folded_dft_np)
from voiceprintrecognition_paddlepaddle_tpu.ops import features as jfeat
from voiceprintrecognition_paddlepaddle_tpu.ops import kaldi as jkaldi
from voiceprintrecognition_paddlepaddle_tpu.ops.pallas_fbank import (
    _folded_dft_np, fbank_pallas)


def _waves(seed, b, n):
    return (np.random.RandomState(seed).randn(b, n) * 0.1).astype(np.float32)


def _assert_fbank_bar(got, ref):
    assert got.shape == ref.shape
    d = np.abs(got - ref)
    assert d.max() < 2e-2
    assert np.percentile(d, 99) < 1e-3


@pytest.mark.parametrize("n_mels", [80, 40])
def test_plain_fbank_matches_jax_kaldi(n_mels):
    w = _waves(0, 3, 16000)
    ref = np.asarray(jkaldi.fbank(w, sr=16000, n_mels=n_mels))
    got = tkaldi.fbank(torch.from_numpy(w), sr=16000, n_mels=n_mels).numpy()
    _assert_fbank_bar(got, ref)


@pytest.mark.parametrize("n_samples", [16000, 8000, 48000 + 123])
def test_fused_reference_matches_jax_kaldi(n_samples):
    w = _waves(1, 2, n_samples)
    ref = np.asarray(jkaldi.fbank(w, sr=16000, n_mels=80))
    got = fbank_fused_reference(torch.from_numpy(w), n_mels=80).numpy()
    _assert_fbank_bar(got, ref)


def test_fused_reference_matches_pallas_interpret():
    w = _waves(2, 2, 16000)
    ref = np.asarray(fbank_pallas(w, sr=16000, n_mels=80, interpret=True))
    got = fbank_fused_reference(torch.from_numpy(w), n_mels=80).numpy()
    _assert_fbank_bar(got, ref)


def test_folded_dft_is_the_jax_table():
    np.testing.assert_array_equal(folded_dft_np(400, 512),
                                  _folded_dft_np(400, 512))


def test_cmn_features_match_compute_feature():
    w = _waves(3, 4, 32000)
    ratios = np.asarray([1.0, 0.31, 0.5, 0.77], np.float32)
    ref = np.asarray(jfeat.compute_feature(w, "Fbank", sr=16000, n_mels=80,
                                           input_lens_ratio=ratios))
    got = tfeat.compute_feature(torch.from_numpy(w), "Fbank", sr=16000,
                                n_mels=80, input_lens_ratio=ratios).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 2e-3
    # exact-length CMN (no ratios) through the featurizer object
    feat = tfeat.AudioFeaturizer("Fbank", {"sr": 16000, "n_mels": 80})
    ref_u = np.asarray(jfeat.compute_feature(w, "Fbank", sr=16000, n_mels=80))
    assert np.abs(feat(w).numpy() - ref_u).max() < 2e-3


def test_apply_cmn_and_mask_matches_jax():
    rng = np.random.RandomState(4)
    raw = rng.randn(3, 97, 80).astype(np.float32)
    ratios = np.asarray([1.0, 0.5, 0.013], np.float32)   # last: 1 frame
    for r in (None, ratios):
        ref = np.asarray(jfeat.apply_cmn_and_mask(raw, r))
        got = tfeat.apply_cmn_and_mask(torch.from_numpy(raw), r).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n", [400, 401, 16000, 56000, 128000])
def test_frame_counts_match_jax(n):
    tf = tfeat.AudioFeaturizer("Fbank", {"sr": 16000, "n_mels": 80})
    jf = jfeat.AudioFeaturizer("Fbank", {"sr": 16000, "n_mels": 80})
    assert tf.num_frames(n) == jf.num_frames(n)
    assert tkaldi.num_frames_kaldi(n, 400, 160, False) == \
        jkaldi.num_frames_kaldi(n, 400, 160, False)
    assert tf.feature_dim == jf.feature_dim == 80


@pytest.mark.parametrize("bad", [dict(dither=1.0), dict(snip_edges=False),
                                 dict(window_type="hamming"),
                                 dict(use_energy=True)])
def test_non_stock_options_raise(bad):
    """These options raised ``NotImplementedError`` while the port had the
    stock options only. Each now takes the plain ``kaldi.fbank`` (no
    kernel launch) and computes the JAX Fbank within the fbank bars, raw
    and CMN'd. Dither cannot match JAX's draws:
    both raise ``ValueError`` without a random source, and the port's
    generator gives the same features twice."""
    w = _waves(7, 2, 16000)
    opts = {"sr": 16000, "n_mels": 80, **bad}
    before = fbank_fused.launches
    if "dither" in bad:
        with pytest.raises(ValueError, match="PRNG"):
            jkaldi.fbank(w, **opts)
        with pytest.raises(ValueError, match="Generator"):
            tkaldi.fbank(torch.from_numpy(w), **opts)
        a, b = (tfeat.compute_feature(
            torch.from_numpy(w), "Fbank", rng=torch.Generator().manual_seed(3),
            **opts) for _ in range(2))
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert tfeat.AudioFeaturizer("Fbank", opts).dither == 1.0
    else:
        ref = np.asarray(jkaldi.fbank(w, **opts))
        _assert_fbank_bar(tkaldi.fbank(torch.from_numpy(w), **opts).numpy(),
                          ref)
        ref = np.asarray(jfeat.AudioFeaturizer("Fbank", opts)(w))
        got = tfeat.AudioFeaturizer("Fbank", opts)(torch.from_numpy(w))
        _assert_fbank_bar(got.numpy(), ref)
    assert fbank_fused.launches == before


def test_other_feature_methods_raise():
    """The default method, MelSpectrogram, raised ``NotImplementedError``
    while the port had Fbank only; it now computes the JAX features
    (< 1e-4 of their scale), and an unknown method raises ``ValueError``
    in both packages."""
    w = _waves(8, 2, 16000)
    ref = np.asarray(jfeat.AudioFeaturizer("MelSpectrogram", {})(w))
    got = tfeat.AudioFeaturizer("MelSpectrogram", {})(torch.from_numpy(w))
    assert got.shape == ref.shape == (2, 126, 64)
    assert np.abs(got.numpy() - ref).max() < 1e-4 * np.abs(ref).max()
    for mod in (tfeat, jfeat):
        with pytest.raises(ValueError, match="unknown feature method"):
            mod.AudioFeaturizer("Chroma", {})


# ---- numpy emulation of the CUDA kernel's algorithm (csrc/fbank.cu) -------
# The kernel runs only on the card; this follows its steps in fp32 on the
# host tables the wrapper passes: 16 lanes per frame, lane l holding the
# packed points z[l + 16 q] = y[2l + 32q] + i y[2l + 32q + 1]; a 16-point
# DFT over q (four-step 4 x 4), the twiddles W_256^(l kq), the transpose,
# a 16-point DFT over l, the split into the real FFT, power, the sparse
# mel product and the log. Arrays index (frame, lane).

_F32 = np.float32


def _emu_w16(v, m, tw):
    a, b = v
    c1, s1, r = tw[32, 0], -tw[32, 1], tw[64, 0]
    return {0: (a, b), 1: (a * c1 + b * s1, b * c1 - a * s1),
            2: (r * (a + b), r * (b - a)),
            3: (a * s1 + b * c1, b * s1 - a * c1),
            4: (b, -a), 6: (r * (b - a), -r * (a + b)),
            9: (-(a * c1 + b * s1), -(b * c1 - a * s1))}[m]


def _emu_dft4(a0, a1, a2, a3):
    s0 = (a0[0] + a2[0], a0[1] + a2[1])
    d0 = (a0[0] - a2[0], a0[1] - a2[1])
    s1 = (a1[0] + a3[0], a1[1] + a3[1])
    d1 = (a1[0] - a3[0], a1[1] - a3[1])
    return [(s0[0] + s1[0], s0[1] + s1[1]), (d0[0] + d1[1], d0[1] - d1[0]),
            (s0[0] - s1[0], s0[1] - s1[1]), (d0[0] - d1[1], d0[1] + d1[0])]


def _emu_dft16(a, tw):
    """Forward 16-point DFT of 16 (re, im) arrays, natural order."""
    b = [_emu_dft4(*(a[p4 + 4 * q4] for q4 in range(4))) for p4 in range(4)]
    b = [[_emu_w16(b[p4][k4], p4 * k4, tw) for k4 in range(4)]
         for p4 in range(4)]
    out = [None] * 16
    for k4 in range(4):
        for kp4, v in enumerate(_emu_dft4(*(b[p4][k4] for p4 in range(4)))):
            out[k4 + 4 * kp4] = v
    return out


def _emulate_kernel(waves, n_mels):
    tables = fbank_tables(16000, n_mels, torch.device("cpu"))
    window, tw, packed, rng = (tables.window.numpy(), tables.twiddles.numpy(),
                               tables.mel_packed.numpy(),
                               tables.mel_range.numpy())
    b, n = waves.shape
    t = tkaldi.num_frames_snip_edges(n, 400, 160)
    frames = waves[:, np.arange(t)[:, None] * 160 + np.arange(400)]
    frames = frames.reshape(-1, 400).astype(_F32)
    lane = np.arange(16)
    x = []                      # x[q] = (x[j], x[j+1]), zero past the frame
    for q in range(16):
        j = np.minimum(2 * lane + 32 * q, 398)
        ok = 2 * lane + 32 * q < 400
        x.append((np.where(ok, frames[:, j], 0).astype(_F32),
                  np.where(ok, frames[:, j + 1], 0).astype(_F32)))
    total = np.zeros((frames.shape[0], 16), _F32)
    for x0, x1 in x:
        total = total + x0
        total = total + x1
    for off in (8, 4, 2, 1):    # the warp's xor reduction
        total = total + total[:, lane ^ off]
    mu = total / _F32(400)
    a = []
    for q, (x0, x1) in enumerate(x):
        j = np.minimum(2 * lane + 32 * q, 398)
        ok = 2 * lane + 32 * q < 400
        xm = frames[:, np.maximum(j - 1, 0)] - mu
        y0 = ((x0 - mu) - _F32(0.97) * xm) * window[j]
        y1 = ((x1 - mu) - _F32(0.97) * (x0 - mu)) * window[j + 1]
        a.append((np.where(ok, y0, 0).astype(_F32),
                  np.where(ok, y1, 0).astype(_F32)))
    a = _emu_dft16(a, tw)       # a[kq]: lanes l
    for kq in range(16):
        w = tw[2 * lane * kq]
        a[kq] = (a[kq][0] * w[:, 0] - a[kq][1] * w[:, 1],
                 a[kq][0] * w[:, 1] + a[kq][1] * w[:, 0])
    # the transpose: lane kq, register p holds A[p][kq]
    re = np.stack([v[0] for v in a], axis=2)          # (frame, l, kq)
    im = np.stack([v[1] for v in a], axis=2)
    z = _emu_dft16([(re[:, p], im[:, p]) for p in range(16)], tw)
    # Z[k], k = kq + 16 kp
    zr = np.stack([v[0] for v in z], axis=1).reshape(-1, 256)
    zi = np.stack([v[1] for v in z], axis=1).reshape(-1, 256)
    # the split in pairs: X[k] = E + W^k O, X[256-k] = conj(E - W^k O)
    k = np.arange(129)
    ar, ai = zr[:, k], zi[:, k]
    br, bi = zr[:, (256 - k) & 255], zi[:, (256 - k) & 255]
    er, ei = _F32(0.5) * (ar + br), _F32(0.5) * (ai - bi)
    o_r, o_i = _F32(0.5) * (ai + bi), _F32(0.5) * (br - ar)
    tr = tw[k, 0] * o_r - tw[k, 1] * o_i
    ti = tw[k, 0] * o_i + tw[k, 1] * o_r
    power = np.empty((frames.shape[0], 256), _F32)
    power[:, :129] = (er + tr) * (er + tr) + (ei + ti) * (ei + ti)
    power[:, 255:128:-1] = ((er - tr) * (er - tr)
                            + (ei - ti) * (ei - ti))[:, 1:128]
    out = np.zeros((frames.shape[0], n_mels), _F32)
    for m, (lo, hi) in enumerate(rng):
        for q in range(lo, hi):
            out[:, m] = out[:, m] + power[:, q] * packed[m, q - lo]
    out = np.log(np.maximum(out, _F32(tkaldi.LOG_EPS)))
    assert out.dtype == _F32
    return out.reshape(b, t, n_mels)


@pytest.mark.parametrize("n_samples", [400, 16000, 48000 + 123])
@pytest.mark.parametrize("n_mels", [80, 40])
@pytest.mark.parametrize("signal", ["noise", "tone_then_silence"])
def test_fft_emulation_matches_jax(signal, n_mels, n_samples):
    w = (_waves(6, 2, n_samples) if signal == "noise"
         else tone_then_silence(n_samples))
    got = _emulate_kernel(w, n_mels)
    exact = fbank_steps(fbank_kernel, torch.from_numpy(w), n_mels).numpy()
    _assert_fbank_bar(got, exact)
    _assert_fbank_bar(got, np.asarray(jkaldi.fbank(w, sr=16000,
                                                   n_mels=n_mels)))
    pallas = np.asarray(fbank_pallas(w, sr=16000, n_mels=n_mels,
                                     interpret=True))
    if signal == "noise":
        _assert_fbank_bar(got, pallas)
    else:
        # on whole frames of the tone the Pallas kernel's 3-pass bf16 DFT
        # itself misses the p99 bar against float64 (low bins far from
        # 1 kHz): the FFT must be nearer float64 than the TPU kernel is
        assert np.abs(got - pallas).max() < 2e-2
        p99 = lambda a: np.percentile(np.abs(a - exact), 99)  # noqa: E731
        assert p99(got) <= p99(pallas)


@pytest.mark.parametrize("n_mels", [80, 40])
def test_fp32_steps_compute_kaldi_fbank(n_mels):
    """``fbank_steps`` in fp32, the composition ``chip_smoke.py`` times as
    ``cufft_ms``, computes the same function as JAX ``kaldi.fbank``."""
    w = _waves(8, 2, 48000 + 123)
    got = fbank_steps(fbank_kernel, torch.from_numpy(w), n_mels,
                      dtype=torch.float32)
    assert got.dtype == torch.float32
    _assert_fbank_bar(got.numpy(), np.asarray(jkaldi.fbank(w, sr=16000,
                                                           n_mels=n_mels)))


def test_kernel_tables():
    tables = fbank_tables(16000, 80, torch.device("cpu"))
    ang = 2 * np.pi * np.arange(512, dtype=np.float64) / 512
    tw = tables.twiddles.numpy()
    np.testing.assert_array_equal(tw[:, 0], np.cos(ang).astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], (-np.sin(ang)).astype(np.float32))
    np.testing.assert_array_equal(tables.window.numpy(),
                                  jkaldi._window_np("povey", 400))
    # the packed filters, zero past each filter's width and 4 bins wide a
    # step, rebuild the mel matrix
    packed = tables.mel_packed.numpy()
    assert packed.shape[1] % 4 == 0
    mel = np.zeros_like(tables.mel.numpy())
    for m, (lo, hi) in enumerate(tables.mel_range.numpy()):
        mel[lo:hi, m] = packed[m, :hi - lo]
        assert not packed[m, hi - lo:].any()
    np.testing.assert_array_equal(mel, tables.mel.numpy())


def test_cpu_tensor_runs_plain_version_without_launch():
    w = torch.from_numpy(_waves(5, 2, 16000))
    before = fbank_fused.launches
    got = fbank_fused(w, n_mels=80)
    assert fbank_fused.launches == before
    torch.testing.assert_close(got, fbank_fused_reference(w, n_mels=80),
                               rtol=0, atol=0)

