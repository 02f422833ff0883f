"""PyTorch port, whole-trunk module: ``trunk_stats_reference`` (the plain
version of ``csrc/campplus_trunk.cu``) against the JAX Pallas trunk kernel
run in interpret mode, at full width on a 1 s clip, exact-length and with
per-utterance ``tvalids``, and on a 24 s input (1199 trunk rows, 12 CAM
segments: the kernel's long mode); the host-side geometry against the JAX
package's; and padding invariance of the plain version. The CUDA kernel
itself is held against the plain version in ``test_torch_gpu.py``.

Bar (``tests/test_pallas_campplus.py:47-48``): cos > 0.9999 and
max |d| / scale < 5e-3 on the pooled stats; 0.999 for a padded row
against its exact-length result (``:114``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import FULL, cos_min, rel_err, synth_campplus
from voiceprintrecognition_paddlepaddle_torch.models import trunk_kernel as tk
from voiceprintrecognition_paddlepaddle_tpu.models import pallas_campplus as pc
from voiceprintrecognition_paddlepaddle_tpu.models.campplus import FCM


@pytest.fixture(scope="module")
def setup():
    jm, v, tm = synth_campplus(FULL, seed=2)
    return v, tm, tk.pack_trunk(tm)


def _fcm_out(v, seed, b, t):
    x = np.random.RandomState(seed).randn(b, t, 80).astype(np.float32)
    return np.array(FCM().apply({"params": v["params"]["FCM_0"],
                                 "batch_stats": v["batch_stats"]["FCM_0"]},
                                jnp.asarray(x), train=False))


def _assert_stats_bar(ref, got):
    assert got.shape == ref.shape
    assert cos_min(ref, got) > 0.9999
    assert rel_err(ref, got) < 5e-3


def test_reference_matches_pallas_exact_length(setup):
    v, _, packed = setup
    fcm = _fcm_out(v, 0, 1, 98)                       # 1 s clip
    ref = np.asarray(pc.trunk_stats_pallas(v, jnp.asarray(fcm),
                                           interpret=True, u=1))
    got = tk.trunk_stats_reference(packed, torch.from_numpy(fcm)).numpy()
    _assert_stats_bar(ref, got)


def test_reference_matches_pallas_with_tvalids(setup):
    v, _, packed = setup
    fcm = _fcm_out(v, 1, 2, 98)
    tvalids = [49, 30]
    ref = np.asarray(pc.trunk_stats_pallas(v, jnp.asarray(fcm),
                                           interpret=True, u=1,
                                           tvalids=tvalids))
    got = tk.trunk_stats_reference(packed, torch.from_numpy(fcm),
                                   tvalids).numpy()
    _assert_stats_bar(ref, got)


def test_reference_matches_pallas_long_input(setup):
    """12 CAM segments, past the shared-memory rows of the kernel."""
    v, _, packed = setup
    fcm = _fcm_out(v, 4, 1, 2398)
    t_valid, t16 = tk.trunk_geometry(2398)
    assert t_valid == 1199 and t16 > tk.SMEM_MAX_T16
    ref = np.asarray(pc.trunk_stats_pallas(v, jnp.asarray(fcm),
                                           interpret=True, u=1))
    got = tk.trunk_stats_reference(packed, torch.from_numpy(fcm)).numpy()
    _assert_stats_bar(ref, got)


def test_padded_rows_match_exact_length(setup):
    """Zero rows past the valid count make a padded clip's stats equal
    its exact-length stats; two segments exercise the CAM segment means."""
    v, _, packed = setup
    fcm = _fcm_out(v, 2, 1, 298)[0]
    valids = [298, 230, 145]
    t_valid, _ = tk.trunk_geometry(298)
    padded = np.zeros((3, 298, 320), np.float32)
    for i, n in enumerate(valids):
        padded[i, :n] = fcm[:n]
    tvalids = [tk.trunk_geometry(n)[0] for n in valids]
    got = tk.trunk_stats_reference(packed, torch.from_numpy(padded),
                                   tvalids).numpy()
    for i, n in enumerate(valids):
        exact = tk.trunk_stats_reference(
            packed, torch.from_numpy(fcm[None, :n])).numpy()
        assert cos_min(exact, got[i:i + 1]) > 0.999, (i, n)


def test_plan_matches_jax():
    ours, theirs = tk.trunk_plan(), pc.trunk_plan()
    for key in ("layers", "lin1_rows", "n_layers", "bn_ch", "growth",
                "final_channels", "blocks", "num_layers", "dilations"):
        assert ours[key] == theirs[key], key


@pytest.mark.parametrize("t_raw", [98, 148, 298, 602, 798, 1598, 3198])
def test_geometry_and_tvalids_match_jax(t_raw):
    t_valid, t16 = tk.trunk_geometry(t_raw)
    assert t_valid == pc.trunk_geometry(t_raw)[0]
    assert t16 % 16 == 0 and t_valid <= t16 < t_valid + 16
    ratios = np.asarray([1.0, 0.75, 0.4, 0.01, 0.333], np.float32)
    ref = [max(1, min(int(math.ceil(r * t_valid)), t_valid)) for r in ratios]
    assert tk.tvalids_from_ratios(ratios, t_valid).tolist() == ref


def test_pack_shapes(setup):
    _, _, packed = setup
    plan = tk.trunk_plan()
    assert packed["w_stem"].shape == (1600, 128)
    assert packed["w_lin1"].shape == (plan["lin1_rows"], 128)
    assert packed["wide_ab"].shape == (55, 2, 1024)
    assert packed["w_local"].shape == (52, 384, 32)
    assert packed["w_cam1"].shape == (52, 128, 64)
    assert packed["w_cam2"].shape == (52, 64, 32)
    assert [packed[f"w_t{b}"].shape for b in range(3)] == [
        (512, 256), (1024, 512), (1024, 512)]
    for k, t in packed.items():
        assert t.is_contiguous() and torch.isfinite(t.float()).all(), k


def test_cpu_tensor_runs_plain_version_without_launch(setup):
    v, _, packed = setup
    fcm = torch.from_numpy(_fcm_out(v, 3, 2, 60))
    before = tk.trunk_stats.launches
    got = tk.trunk_stats(packed, fcm, [30, 12])
    assert tk.trunk_stats.launches == before
    torch.testing.assert_close(
        got, tk.trunk_stats_reference(packed, fcm, [30, 12]), rtol=0, atol=0)

