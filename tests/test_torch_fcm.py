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


def test_launch_units_and_bytes(setup):
    """The units each launch of the kernel reads and writes (one unit: one
    frequency of 32 bf16 channels over every frame) add up to the design's
    775, 2.54 GB at b32 x 1598 and 3.78 GB at b256 x 298; the operations
    are those of the packed weights."""
    _, tm = setup
    packed = fkm.pack_fcm(tm)
    assert [n for n, *_ in fkm.FCM_LAUNCHES] == [
        "conv0", "c1", "c2+sc3", "c4", "c5", "c6", "c7+sc8", "c9", "c10",
        "c11"]
    assert sum(r + w for *_, r, w in fkm.FCM_LAUNCHES) == 775
    for (b, t), gb in (((32, 1598), 2.536), ((256, 298), 3.784)):
        costs = fkm.fcm_launch_costs(b, t)
        total = sum(c["bytes"] for c in costs)
        assert total == 775 * b * t * 64
        assert abs(total / 1e9 - gb) < 1e-3
    # 2 x MACs of every packed conv at its output frequencies, the 1x1
    # shortcuts (3, 8) in the launches of convs 2 and 7
    f_out = [80, 40, 40, 40, 40, 40, 20, 20, 20, 20, 20, 10]
    macs = [packed[f"w{i}"].shape[0] * 32 * f_out[i] for i in range(12)]
    by_launch = [macs[0], macs[1], macs[2] + macs[3], macs[4], macs[5],
                 macs[6], macs[7] + macs[8], macs[9], macs[10], macs[11]]
    costs = fkm.fcm_launch_costs(2, 7)
    assert [c["flop"] for c in costs] == [2 * 14 * m for m in by_launch]


@pytest.mark.parametrize("b,t,f_out,want", [
    (32, 1598, 40, 32 * 50 * 4), (32, 1598, 10, 32 * 50), (3, 17, 20, 6),
    (1, 1000, 40, 32 * 4), (256, 298, 20, 256 * 10 * 2), (2, 3198, 10, 200)])
def test_conv_items(b, t, f_out, want):
    """Items of a conv launch: (32-frame tile, 10-frequency band, utterance);
    a ragged last tile counts."""
    assert fkm.fcm_conv_items(b, t, f_out) == want


@pytest.mark.parametrize("n_items,n_sms,per_sm,want", [
    (6400, 132, 1, 132), (6400, 132, 2, 264), (100, 132, 1, 100),
    (1, 132, 1, 1), (132, 132, 1, 132), (133, 132, 1, 132)])
def test_persistent_grid(n_items, n_sms, per_sm, want):
    """The grid is the card's resident blocks, or the items if fewer; each
    block then walks items blockIdx.x, + grid, ..., so every item runs
    once."""
    grid = fkm.persistent_grid(n_items, n_sms, per_sm)
    assert grid == want
    walked = sorted(i for blk in range(grid)
                    for i in range(blk, n_items, grid))
    assert walked == list(range(n_items))


def test_persistent_grid_needs_a_resident_block():
    with pytest.raises(ValueError, match="no resident block"):
        fkm.persistent_grid(10, 132, 0)


_OCC = {"stride 2": 1, "shortcut": 1, "stride 1": 2, "identity": 1,
        "sms": 132}


@pytest.mark.parametrize("b,t,want", [
    (32, 1598, [132, 132, 264, 132, 132, 132, 264, 132, 132]),
    (3, 17, [12, 12, 12, 12, 6, 6, 6, 6, 3]),
    (1, 1598, [132, 132, 200, 132, 100, 100, 100, 100, 50])])
def test_fcm_grids(b, t, want):
    """The grids the wrapper passes to the kernel's nine conv launches:
    each launch's items, capped by its instance's resident blocks."""
    assert [k for _, k, *_ in fkm.FCM_LAUNCHES[1:]] == [
        "stride 2", "shortcut", "stride 1", "identity", "stride 2",
        "shortcut", "stride 1", "identity", "stride 2"]
    assert fkm.fcm_grids(b, t, _OCC) == want
