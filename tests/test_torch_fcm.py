"""PyTorch port, FCM module: ``fcm_reference`` (the plain version of
``csrc/fcm.cu``) against the JAX Pallas FCM kernel run in interpret mode,
and against the flax ``FCM``, at full width. The lengths cover the
single-pass kernel (298, 297: an odd length with a half-valid last time
group, 17) and the chunked one (600, 601: ``t2p > 256``). The CUDA kernel
itself is held against the plain version in ``test_torch_gpu.py`` and
``chip_smoke.py``.

Bars (``tests/test_pallas_fcm.py:44``, ``:55-56``): bf16 packing
cos > 0.9999 and max |d| < 5e-2 x scale; fp32 packing max |d| < 1e-4 x
scale, with scale = max(1, max |ref|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import FULL, synth_campplus
from voiceprintrecognition_paddlepaddle_torch.models import fcm_kernel as fkm
from voiceprintrecognition_paddlepaddle_tpu.models import pallas_fcm
from voiceprintrecognition_paddlepaddle_tpu.models.campplus import FCM

LENGTHS = [298, 297, 17, 600, 601]


@pytest.fixture(scope="module")
def setup():
    _, v, tm = synth_campplus(FULL, seed=4)
    return v, tm


def _feats(t, b=1):
    return np.random.RandomState(t).randn(b, t, 80).astype(np.float32)


def _scale(ref):
    return max(1.0, float(np.abs(ref).max()))


def _cos(a, b):
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("t", LENGTHS)
def test_bf16_reference_matches_pallas(setup, t):
    v, tm = setup
    x = _feats(t)
    ref = np.asarray(pallas_fcm.fcm_pallas(v, jnp.asarray(x),
                                           interpret=True)).astype(np.float32)
    got = fkm.fcm_reference(fkm.pack_fcm(tm), torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert got.shape == ref.shape == (1, t, 320)
    assert _cos(ref, got) > 0.9999
    assert np.abs(ref - got).max() < 5e-2 * _scale(ref)


@pytest.mark.parametrize("t", LENGTHS)
def test_fp32_reference_matches_pallas_and_flax(setup, t):
    v, tm = setup
    x = _feats(t)
    packed_j = pallas_fcm.pack_fcm(v, compute_dtype=jnp.float32)
    pallas = np.asarray(pallas_fcm.fcm_pallas(v, jnp.asarray(x), interpret=True,
                                              packed=packed_j))
    flax = np.asarray(FCM().apply({"params": v["params"]["FCM_0"],
                                   "batch_stats": v["batch_stats"]["FCM_0"]},
                                  jnp.asarray(x), train=False))
    got = fkm.fcm_reference(fkm.pack_fcm(tm, torch.float32),
                            torch.from_numpy(x)).numpy()
    for ref in (pallas, flax):
        assert got.shape == ref.shape == (1, t, 320)
        assert np.abs(ref - got).max() < 1e-4 * _scale(ref)


def test_reference_matches_eager_fcm_module(setup):
    """fp32 packing computes the torch ``FCM`` module's function."""
    _, tm = setup
    x = torch.from_numpy(_feats(40, b=2))
    ref = tm.FCM_0(x).numpy()
    got = fkm.fcm_reference(fkm.pack_fcm(tm, torch.float32), x).numpy()
    assert np.abs(ref - got).max() < 1e-4 * _scale(ref)


def test_batch_independence(setup):
    """Each utterance's result is independent of the rest of the batch."""
    _, tm = setup
    packed = fkm.pack_fcm(tm)
    x = torch.from_numpy(_feats(96, b=5))
    full = fkm.fcm_reference(packed, x)
    one = fkm.fcm_reference(packed, x[2:3])
    torch.testing.assert_close(full[2:3], one, rtol=0, atol=0)


def test_pack_layout(setup):
    _, tm = setup
    packed = fkm.pack_fcm(tm)
    assert packed["w0"].shape == (9, 32)
    assert packed["w3"].shape == packed["w8"].shape == (32, 32)
    for i in (1, 2, 4, 5, 6, 7, 9, 10, 11):
        assert packed[f"w{i}"].shape == (288, 32), i
    assert packed["aff"].shape == (12, 2, 32)
    assert packed["aff"].dtype == torch.float32
    # row (df * 3 + dt) * cin + c holds weight[:, c, df, dt]
    w = tm.FCM_0.BasicResBlock_0.Conv_0.weight
    np.testing.assert_array_equal(
        packed["w1"][(2 * 3 + 1) * 32 + 5].float().numpy(),
        w[:, 5, 2, 1].to(torch.bfloat16).float().numpy())


def test_supported_gate():
    assert fkm.fcm_supported(298, 80) == pallas_fcm.fcm_supported(298, 80)
    assert fkm.fcm_supported(fkm.FCM_MAX_FRAMES, 80)
    assert not fkm.fcm_supported(fkm.FCM_MAX_FRAMES + 1, 80)
    assert not fkm.fcm_supported(298, 64)
    assert fkm.FCM_MAX_FRAMES == pallas_fcm.FCM_MAX_FRAMES


def test_cpu_tensor_runs_plain_version_without_launch(setup):
    _, tm = setup
    packed = fkm.pack_fcm(tm)
    x = torch.from_numpy(_feats(33, b=2))
    before = fkm.fcm_fused.launches
    got = fkm.fcm_fused(packed, x)
    assert fkm.fcm_fused.launches == before
    torch.testing.assert_close(got, fkm.fcm_reference(packed, x), rtol=0, atol=0)
    with pytest.raises(ValueError, match="expected"):
        fkm.fcm_fused(packed, torch.zeros(1, 10, 64))
