"""PyTorch port, FCM module: ``fcm_reference`` (the plain version of
``csrc/fcm.cu``) against the JAX Pallas FCM kernel run in interpret mode,
and against the flax ``FCM``, at full width. The lengths cover the
single-pass kernel (298, 297: an odd length with a half-valid last time
group, 17) and the chunked one (600, 601: ``t2p > 256``). The CUDA kernel
itself is held against the plain version in ``test_torch_gpu.py``; here
its plan (``fkm.FCM_LAUNCHES``: four launches, their items and each item's
tiles with their halos) runs in plain PyTorch (``_emulate_plan``) against
``fcm_reference``.

Bars (``tests/test_pallas_fcm.py:44``, ``:55-56``): bf16 packing
cos > 0.9999 and max |d| < 5e-2 x scale; fp32 packing max |d| < 1e-4 x
scale, with scale = max(1, max |ref|). The plan's emulation: cos >
0.99999 and max |d| < 1e-2 x scale (one bf16 rounding flip where the
CPU's order of sums differs on a tile).
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


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads for this file: the suite runs six workers on the
    host's cores, and one torch thread per core in each oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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
    215, 0.704 GB at b32 x 1598 and 1.050 GB at b256 x 298; the operations
    are those of the packed weights, and the design's (halos and ragged
    m-tiles included) exceed them by under a third."""
    _, tm = setup
    packed = fkm.pack_fcm(tm)
    assert [ln.name for ln in fkm.FCM_LAUNCHES] == ["A", "B", "C", "D"]
    assert [(ln.read_units, ln.write_units) for ln in fkm.FCM_LAUNCHES] == [
        (5, 40), (40, 40), (40, 20), (20, 10)]
    assert sum(ln.read_units + ln.write_units for ln in fkm.FCM_LAUNCHES) == 215
    for (b, t), gb in (((32, 1598), 0.7036), ((256, 298), 1.0497)):
        costs = fkm.fcm_launch_costs(b, t)
        total = sum(c["bytes"] for c in costs)
        assert total == 215 * b * t * 64
        assert abs(total / 1e9 - gb) < 1e-3
        for c in costs:
            assert c["flop"] < c["design_flop"] < 1.33 * c["flop"], c
    # 2 x MACs of every packed conv at its output frequencies: conv0 in the
    # first launch, c11 in the last, the 1x1 shortcuts (3, 8) in the
    # launches of convs 2 and 7
    f_out = [80, 40, 40, 40, 40, 40, 20, 20, 20, 20, 20, 10]
    macs = [packed[f"w{i}"].shape[0] * 32 * f_out[i] for i in range(12)]
    by_launch = [sum(macs[0:4]), sum(macs[4:6]), sum(macs[6:9]),
                 sum(macs[9:12])]
    costs = fkm.fcm_launch_costs(2, 7)
    assert [c["flop"] for c in costs] == [2 * 14 * m for m in by_launch]
    convs = [t.conv for ln in fkm.FCM_LAUNCHES for t in ln.tiles[1:]]
    assert sorted(convs + [3, 8]) == list(range(12))


@pytest.mark.parametrize("b,t,name,want", [
    (32, 1598, "B", 32 * 50 * 4), (32, 1598, "D", 32 * 100), (3, 17, "C", 6),
    (1, 1000, "A", 63 * 4), (256, 298, "C", 256 * 10 * 2), (2, 3198, "D", 400),
    (1, 1598, "D", 100)])
def test_conv_items(b, t, name, want):
    """Items of a launch: (time tile, band, utterance), 16 frames by 10
    output frequencies in A, 32 by 10 in B and C, 16 by all 10 in D; a
    ragged last tile counts. One long clip still gives D 100 items."""
    ln = next(ln for ln in fkm.FCM_LAUNCHES if ln.name == name)
    assert fkm.fcm_items(b, t, ln) == want


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


_OCC = {"A": 2, "B": 2, "C": 1, "D": 1, "sms": 132}


@pytest.mark.parametrize("b,t,want", [
    (32, 1598, [264, 264, 132, 132]),
    (3, 17, [24, 12, 6, 6]),
    (1, 1598, [264, 200, 100, 100])])
def test_fcm_grids(b, t, want):
    """The grids the wrapper passes to the kernel's four launches: each
    launch's items, capped by its kernel's resident blocks."""
    assert fkm.fcm_grids(b, t, _OCC) == want


# ---- the kernel's plan in plain PyTorch -----------------------------------

def _random_packed(seed):
    """Packed FCM weights from a numpy seed (bf16 weights, fp32 affines
    whose shifts are large enough that relu(affine(0)) is not zero)."""
    rng = np.random.RandomState(seed)
    packed = {}
    for i in range(12):
        rows = 9 if i == 0 else 32 if i in (3, 8) else 288
        packed[f"w{i}"] = torch.from_numpy(
            (rng.randn(rows, 32) / np.sqrt(rows)).astype(np.float32)
        ).to(torch.bfloat16)
    packed["aff"] = torch.from_numpy(np.stack(
        [rng.uniform(0.5, 1.5, (12, 32)), rng.uniform(0.1, 0.5, (12, 32))],
        axis=1).astype(np.float32))
    return packed


def _checked(idx, n):
    """An index into a tile of ``n`` rows or slots: the plan must never
    read past the tile it sized."""
    assert int(idx.min()) >= 0 and int(idx.max()) < n, (idx.min(), idx.max(), n)
    return idx


def _emulate_plan(packed, feats):
    """``fkm.FCM_LAUNCHES`` in plain PyTorch: per launch and item, tile 0
    sliced from the launch's input with zeros outside [0, T) and the layer,
    each later tile computed from the one before over the frames and
    frequencies the plan gives it (every position outside [0, T) or the
    layer stored as zero, the rest rounded to bf16), the last tile cropped
    into the launch's output."""
    cd = packed["w1"].dtype
    aff = packed["aff"]
    b, t_len, _ = feats.shape
    x = feats.to(cd).float()[..., None]             # (B, T, 80, 1)
    for ln in fkm.FCM_LAUNCHES:
        out = torch.zeros(b, t_len, ln.f_out, 32)
        n_tt, n_fb = -(-t_len // ln.tt), ln.f_out // ln.fb
        for item in range(fkm.fcm_items(b, t_len, ln)):
            f0, rest = (item % n_fb) * ln.fb, item // n_fb
            t0, bi = (rest % n_tt) * ln.tt, rest // n_tt

            def frames(tile):
                return t0 - tile.halo + torch.arange(ln.tt + 2 * tile.halo)

            def freqs(tile):
                return tile.scale * f0 + tile.off + torch.arange(tile.slots)

            tiles = []
            for k, tile in enumerate(ln.tiles):
                tf, ff = frames(tile), freqs(tile)
                slot = torch.arange(tile.slots)
                keep = (((tf >= 0) & (tf < t_len))[:, None]
                        & ((ff >= 0) & (ff < tile.width)
                           & (slot >= tile.lo) & (slot < tile.hi))[None, :])
                if k == 0:
                    v = x[bi][tf.clamp(0, t_len - 1)][:, ff.clamp(
                        0, tile.width - 1)]
                    tiles.append(torch.where(keep[..., None], v, 0.0))
                    continue
                prev, pin = ln.tiles[k - 1], tiles[k - 1]
                stride = prev.width // tile.width
                d = torch.arange(3)
                rows = _checked(tf[:, None] - 1 + d - frames(prev)[0],
                                pin.shape[0])                   # (R, dt)
                cols = _checked(stride * ff[tile.lo:tile.hi, None] - 1 + d
                                - freqs(prev)[0], pin.shape[1])  # (S, df)
                win = pin[rows][:, :, cols]                      # (R, dt, S, df, c)
                cin = pin.shape[-1]
                w = packed[f"w{tile.conv}"].float().reshape(3, 3, cin, 32)
                y = (torch.einsum("rtsfc,ftco->rso", win, w) * aff[tile.conv, 0]
                     + aff[tile.conv, 1])
                if tile.res >= 0:
                    src, sin = ln.tiles[tile.res], tiles[tile.res]
                    sc = 2 if tile.res_conv >= 0 else 1
                    r_rows = _checked(tf - frames(src)[0], sin.shape[0])
                    r_cols = _checked(sc * ff[tile.lo:tile.hi] - freqs(src)[0],
                                      sin.shape[1])
                    xr = sin[r_rows][:, r_cols]
                    if tile.res_conv >= 0:
                        xr = (xr @ packed[f"w{tile.res_conv}"].float()
                              * aff[tile.res_conv, 0] + aff[tile.res_conv, 1])
                    y = y + xr
                full = torch.zeros(len(tf), tile.slots, 32)
                full[:, tile.lo:tile.hi] = torch.relu(y).to(cd).float()
                tiles.append(torch.where(keep[..., None], full, 0.0))
            n = min(ln.tt, t_len - t0)
            out[bi, t0:t0 + n, f0:f0 + ln.fb] = tiles[-1][:n]
        x = out
    return x.reshape(b, t_len, 320).to(cd)


@pytest.mark.parametrize("b,t", [(1, 5), (2, 33), (1, 298)])
def test_plan_matches_reference(b, t):
    """T = 5 is shorter than every halo, 33 one frame past a 32-frame tile,
    298 a 3 s bucket (ragged tiles in every launch)."""
    packed = _random_packed(7)
    x = torch.from_numpy(np.random.RandomState(t).randn(b, t, 80).astype(
        np.float32))
    ref = fkm.fcm_reference(packed, x).double()
    got = _emulate_plan(packed, x).double()
    assert got.shape == ref.shape == (b, t, 320)
    cos = float((got * ref).sum() / (got.norm() * ref.norm()))
    assert cos > 0.99999
    assert float((got - ref).abs().max()) < 1e-2 * max(1.0, float(ref.abs().max()))


def test_plan_tiles_fit_and_chain():
    """Each tile's halo is one frame less than the tile before (one 3x3
    conv), a stride-2 tile's band sits on the frequency map 2f - 1 .. 2f +
    1 of the tile before, and the last tile is the item's own tt x fb."""
    for ln in fkm.FCM_LAUNCHES:
        assert ln.tiles[0].conv == -1
        for prev, tile in zip(ln.tiles, ln.tiles[1:]):
            assert prev.halo == tile.halo + 1
            assert prev.width in (tile.width, 2 * tile.width)
        last = ln.tiles[-1]
        assert (last.halo, last.scale, last.off, last.slots, last.width) == (
            0, 1, 0, ln.fb, ln.f_out)
        assert ln.f_out % ln.fb == 0
    assert fkm.FCM_LAUNCHES[0].tiles[1].conv == 0
    assert fkm.FCM_LAUNCHES[-1].tiles[-1].conv == 11


# ---- fcm_variants.py: its rewrites still match csrc/fcm.cu ---------------

def _plan_settings(src):
    """Each launch's (warps, tt, stages, blocks) as plan() states them."""
    import fcm_variants as fv
    tts = [int(m.group(1)) for m in fv._HEAD.finditer(src)]
    tails = [(int(m.group(3)), int(m.group(1)), int(m.group(2)))
             for m in fv._TAIL.finditer(src)]
    return [(w, tt, st, bl) for tt, (w, st, bl) in zip(tts, tails)]


def test_fcm_variants_rewrite_the_source():
    """``fcm_variants.py`` rewrites the four launches' settings of
    ``plan()`` and applies each ablation exactly once; the source as built
    is left alone."""
    import fcm_variants as fv
    with open(fv.SRC, encoding="utf-8") as f:
        src = f.read()
    built = _plan_settings(src)
    assert len(built) == 4
    assert [tt for _, tt, _, _ in built] == [ln.tt for ln in fkm.FCM_LAUNCHES]
    assert fv.variant_source(src, *fv.parse("as-built")) == src
    per, flags = fv.parse("10/32/2/1_12/16/1/2_8/32/2/1_6/16/2/1,nobar+eldB")
    out = fv.variant_source(src, per, flags)
    assert _plan_settings(out) == per
    for f in fv.ABLATIONS:
        assert src.count(fv.ABLATIONS[f][0]) == 1, f
    with pytest.raises(ValueError, match="unknown ablation"):
        fv.parse("as-built,nommu")
