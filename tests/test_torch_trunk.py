"""PyTorch port, whole-trunk module: ``trunk_stats_reference`` (the plain
version of ``csrc/campplus_trunk.cu``) against the JAX Pallas trunk kernel
run in interpret mode, at full width on a 1 s clip, exact-length and with
per-utterance ``tvalids``, and on a 24 s input (1199 trunk rows, 12 CAM
segments: more rows than one block holds); the host-side geometry against
the JAX package's; padding invariance of the plain version; the cluster
split rule ``trunk_split``; and an emulation of the kernel's split of an
utterance's rows across the blocks of a cluster (halo copy, partial CAM
segment sums added in rank order, two-pass pooled exchange) against the
plain version. The CUDA kernel itself is held against the plain version
in ``test_torch_gpu.py``.

Bar (``tests/test_pallas_campplus.py:47-48``): cos > 0.9999 and
max |d| / scale < 5e-3 on the pooled stats; 0.999 for a padded row
against its exact-length result (``:114``). The emulated split: within
1e-6 relative of the plain version with one block (the same sums in the
same order), and cos > 0.99999 with relative max |d| < 1e-3 with more
(only the order of the fp32 partial sums differs, which can flip a bf16
rounding of the CAM context).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
    slices = sum(-(-s["cin"] // 64) for s in plan["layers"])
    assert slices == 492 and tk.lin1_offsets()[-1] == slices - 16
    assert packed["w_stem"].shape == (1600 // 64, 8192)
    assert packed["w_lin1"].shape == (slices, 8192)
    assert packed["wide_ab"].shape == (55, 2, 1024)
    assert packed["w_local"].shape == (52, 384 * 32)
    assert packed["w_cam1"].shape == (52, 128, 64)
    assert packed["w_cam2"].shape == (52, 64, 32)
    assert [packed[f"w_t{b}"].shape for b in range(3)] == [
        (2 * 8, 8192), (4 * 16, 8192), (4 * 16, 8192)]
    for k, t in packed.items():
        assert t.is_contiguous() and torch.isfinite(t.float()).all(), k
    w = tk.trunk_weights(packed)
    assert w["w_stem"].shape == (1600, 128)
    assert w["w_lin1"].shape == (plan["lin1_rows"], 128)
    assert w["w_local"].shape == (52, 384, 32)
    assert [w[f"w_t{b}"].shape for b in range(3)] == [
        (512, 256), (1024, 512), (1024, 512)]


def _plain_weights(tm):
    """The products' weights as plain (K, N) bf16 matrices, straight from
    the module (the layouts before the kernel's wgmma slices)."""
    plan = tk.trunk_plan()
    bf = torch.bfloat16
    w = tm.TDNNLayer_0.Conv_0.weight.float()
    out = {"w_stem": w.permute(2, 1, 0).reshape(-1, w.shape[0]).to(bf)}
    lin1, local = [], []
    for bi, n in enumerate(plan["num_layers"]):
        blk = getattr(tm, f"CAMDenseTDNNBlock_{bi}")
        for li in range(n):
            layer = getattr(blk, f"CAMDenseTDNNLayer_{li}")
            lin1.append(layer.Conv_0.weight[:, :, 0].float().t())
            cw = layer.CAMLayer_0.Conv_0.weight.float()
            local.append(cw.permute(2, 1, 0).reshape(-1, cw.shape[0]))
        out[f"w_t{bi}"] = getattr(tm, f"Conv_{bi}").weight[:, :, 0].float().t().to(bf)
    out["w_lin1"] = torch.cat(lin1).to(bf)
    out["w_local"] = torch.stack(local).to(bf)
    return out


def test_wgmma_packing_unpacks_bit_for_bit(setup):
    """``trunk_weights`` gives back every product's plain weights exactly
    from the kernel's slice order, and that order is the one the kernel
    reads: slice (pass p, K slice s) is 8192 elements, element (k, n) at
    line n % 128 (64 elements a line), 8-element chunk (k % 64 // 8) ^ (n
    % 8) of it (wgmma's 128-byte swizzle); a layer's slices past its cin
    are zero; the local conv's (k, n) at (n // 8) * 3072 + (k // 8) * 64 +
    (n % 8) * 8 + k % 8."""
    _, tm, packed = setup
    plain = _plain_weights(tm)
    got = tk.trunk_weights(packed)
    assert set(got) == set(plain)
    for k, v in plain.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    rng = np.random.RandomState(5)
    for name, (kk, nn) in (("w_stem", (1600, 128)), ("w_t1", (1024, 512))):
        flat = packed[name].reshape(-1)
        for k, n in zip(rng.randint(0, kk, 64), rng.randint(0, nn, 64)):
            p, s, line = n // 128, k // 64, n % 128
            idx = ((p * (kk // 64) + s) * 8192 + line * 64
                   + ((k % 64 // 8) ^ (line & 7)) * 8 + k % 8)
            assert torch.equal(flat[idx], plain[name][k, n]), (name, k, n)
    plan = tk.trunk_plan()
    for spec, off in zip(plan["layers"], tk.lin1_offsets()):
        cin = spec["cin"]
        layer = tk._untile_slices(packed["w_lin1"][off:off + -(-cin // 64)],
                                  -(-cin // 64) * 64, 128)
        assert not layer[cin:].any(), cin                  # zero past cin
    for l, k, n in zip(rng.randint(0, 52, 64), rng.randint(0, 384, 64),
                       rng.randint(0, 32, 64)):
        idx = (n // 8) * 3072 + (k // 8) * 64 + (n % 8) * 8 + k % 8
        assert torch.equal(packed["w_local"][l, idx], plain["w_local"][l, k, n])


def _schedule(t16, cs, tv=None):
    """The kernel's walk over one utterance of ``tv`` valid rows (``None``:
    every row), in Python: for each block of the cluster, its computed
    rows (those it owns below ``tv`` rounded up to 16, csrc ``nc``), each
    row pass of up to ``PASS_TILES`` 64-row tiles over them (one a
    warpgroup) and each thread's A chunks of a K slice (thread t of
    warpgroup wg: lines ``(t >> 3) + 16 j``, j < 4, of tile wg, columns
    ``8 * (t & 7)`` of the slice). Yields (rank, first trunk row of the
    pass, tiles, [(trunk row, column chunk)] of the rows the block
    computes)."""
    rows = tk.rows_per_block(t16, cs)
    tv = t16 if tv is None else tv
    for rank in range(cs):
        r0 = min(rank * rows, t16)
        nr = min(r0 + rows, t16) - r0
        rv = max(r0, min(r0 + nr, tv))
        nc = min(nr, -(-(rv - r0) // 16) * 16)
        for rp in range(0, nc, tk.TILE_ROWS * tk.PASS_TILES):
            nt = min(tk.PASS_TILES, -(-(nc - rp) // tk.TILE_ROWS))
            copied = []
            for tid in range(128 * nt):                  # a warpgroup a tile
                wg, t = tid >> 7, tid & 127
                for j in range(4):
                    row = rp + wg * tk.TILE_ROWS + (t >> 3) + 16 * j
                    if row < nc:
                        copied.append((r0 + row, t & 7))
            yield rank, r0 + rp, nt, copied


def _split_cases():
    """Every (t16, cs) the split rule can take, over every batch size the
    tests' resident table distinguishes."""
    cases = set()
    for t16 in range(16, tk.MAX_T16 + 1, 16):
        for b in (1, 3, 30, 64, 256):
            cases.add((t16, tk.trunk_split(b, t16, h100_resident)[0]))
    return sorted(cases)


def test_tile_schedule_covers_every_row_and_column_once():
    """For every t16 and split the rule can take: each trunk row < t16 is
    staged by exactly one block's pass, once per 8-column chunk of a slice;
    every K column of every product lies in one of its ceil(K / 64) slices,
    the last one partial where K is not a multiple of 64 (the kernel zeroes
    its columns past K, and the packed weights are zero there); the weight
    slices of a pass serve all of its tiles, a pass holds at most
    ``PASS_TILES`` tiles, and a block of up to that many tiles runs one
    pass."""
    plan = tk.trunk_plan()
    ks = [5 * 320, *(s["cin"] for s in plan["layers"]),
          *(b["c_out"] for b in plan["blocks"])]
    for k in ks:
        n = -(-k // tk.K_SLICE)
        cols = [c for s in range(n) for c in range(s * tk.K_SLICE, (s + 1) * tk.K_SLICE)
                if c < k]
        assert cols == list(range(k)), k
    assert any(k % tk.K_SLICE for k in ks)          # the partial slices exist
    assert all(b["c_transit"] % tk.N_PASS == 0 for b in plan["blocks"])
    for t16, cs in _split_cases():
        seen = {}
        for rank, g0, nt, copied in _schedule(t16, cs):
            assert 1 <= nt <= tk.PASS_TILES
            for g, q in copied:
                seen[(g, q)] = seen.get((g, q), 0) + 1
        assert sorted(seen) == [(g, q) for g in range(t16) for q in range(8)], (t16, cs)
        assert set(seen.values()) == {1}, (t16, cs)
        rows = tk.rows_per_block(t16, cs)
        passes = [rank for rank, *_ in _schedule(t16, cs)]
        for rank in set(passes):
            want = -(-min(rows, t16 - rank * rows) // (tk.TILE_ROWS * tk.PASS_TILES))
            assert passes.count(rank) == want, (t16, cs, rank)


# valid counts at the tile edges; None: the utterance's last row (t16)
SCHEDULE_TVALIDS = [1, 15, 16, 63, 64, 65, 128, 129, 192, 193, None]


@pytest.mark.parametrize("tv", SCHEDULE_TVALIDS)
def test_tile_schedule_runs_only_the_valid_tiles(tv):
    """For every t16 and split the rule can take, and a valid count at each
    tile edge: every row below it is staged exactly once per 8-column
    chunk, no row at or past it rounded up to 16 is, a block runs
    ceil(its valid tiles / ``PASS_TILES``) passes (none without valid
    rows), and ``trunk_tiles`` counts the tiles of the blocks' rows and
    the tiles the walk runs."""
    for t16, cs in _split_cases():
        v = t16 if tv is None else tv
        if v > t16:
            continue
        rows = tk.rows_per_block(t16, cs)
        seen, run, passes = {}, 0, {}
        for rank, g0, nt, copied in _schedule(t16, cs, v):
            run += nt
            passes[rank] = passes.get(rank, 0) + 1
            for g, q in copied:
                seen[(g, q)] = seen.get((g, q), 0) + 1
        v16 = -(-v // 16) * 16
        assert all(g < v16 for g, _ in seen), (t16, cs, v)
        assert {(g, q) for g in range(v) for q in range(8)} <= set(seen), (t16, cs, v)
        assert set(seen.values()) == {1}, (t16, cs, v)
        for rank in range(cs):
            r0 = min(rank * rows, t16)
            valid = max(0, min(r0 + rows, t16, v16) - r0)
            want = -(-(-(-valid // tk.TILE_ROWS)) // tk.PASS_TILES)
            assert passes.get(rank, 0) == want, (t16, cs, v, rank)
        tiles, tiles_run = tk.trunk_tiles([v, t16], t16, cs, rows)
        owned = sum(-(-(min(r0 + rows, t16) - r0) // tk.TILE_ROWS)
                    for r0 in (min(k * rows, t16) for k in range(cs)))
        full = sum(nt for *_, nt, _ in _schedule(t16, cs))
        assert tiles.tolist() == [owned, owned] and full == owned, (t16, cs)
        assert tiles_run.tolist() == [run, full], (t16, cs, v)


def test_launch_order_puts_the_most_tiles_first():
    """A permutation of the batch whose tiles run do not increase, ties in
    batch order; the identity when every utterance is whole."""
    rng = np.random.RandomState(7)
    t_valid, t16 = tk.trunk_geometry(398)
    tv = rng.randint(1, t_valid + 1, 256)
    for cs in (1, 2, 4, 8):
        rows = tk.rows_per_block(t16, cs)
        _, run = tk.trunk_tiles(tv, t16, cs, rows)
        order = tk.launch_order(run)
        assert sorted(order.tolist()) == list(range(256))
        assert (np.diff(run[order]) <= 0).all(), cs
        for n in set(run.tolist()):                      # stable
            same = order[run[order] == n]
            assert (np.diff(same) > 0).all(), (cs, n)
        _, whole = tk.trunk_tiles(np.full(256, t_valid), t16, cs, rows)
        assert tk.launch_order(whole).tolist() == list(range(256))


def test_embed_4s_skips_about_three_tenths_of_the_tiles():
    """The benchmark's 2-4 s clips padded to the 4 s bucket (398 frames;
    ``benchmark/traffic_gen.lengths``' stratified lengths), at b256's
    split on the H100 (one block of 208 rows a clip): the kernel runs
    about 0.70 of the tiles the blocks own."""
    t_valid, t16 = tk.trunk_geometry(398)
    cs, rows = tk.trunk_split(256, t16, h100_resident)
    assert (cs, rows) == (1, 208)
    n = 2048
    lens = np.round((2.0 + 2.0 * (np.arange(n) + 0.5) / n) * 16000)
    tv = tk.tvalids_from_ratios((lens / 64000).astype(np.float32), t_valid)
    tiles, run = tk.trunk_tiles(tv, t16, cs, rows)
    assert set(tiles.tolist()) == {4} and set(run.tolist()) == {2, 3, 4}
    assert 0.68 < run.sum() / tiles.sum() < 0.71


def test_each_append_lies_in_the_next_products_last_slice():
    """The kernel fences a layer's gated append (32 concat columns written
    with ordinary stores) just before the TMA copy of the next product's
    last K slice, so those columns must lie in that slice and in no
    earlier one, for every bottleneck after a block's first and for every
    transit; a block's first bottleneck reads the stem's or the transit's
    output from its first slice (fenced at its start)."""
    plan = tk.trunk_plan()
    reads = [(s["cin"], s["li"] > 0) for s in plan["layers"]]
    reads += [(b["c_out"], True) for b in plan["blocks"]]
    for k, after_append in reads:
        if not after_append:
            continue
        last = -(-k // tk.K_SLICE) - 1
        assert {c // tk.K_SLICE for c in range(k - 32, k)} == {last}, k
    firsts = [s["cin"] for s in plan["layers"] if s["li"] == 0]
    assert firsts == [b["c_in"] for b in plan["blocks"]]


def test_cpu_tensor_runs_plain_version_without_launch(setup):
    v, _, packed = setup
    fcm = torch.from_numpy(_fcm_out(v, 3, 2, 60))
    before = tk.trunk_stats.launches
    got = tk.trunk_stats(packed, fcm, [30, 12])
    assert tk.trunk_stats.launches == before
    torch.testing.assert_close(
        got, tk.trunk_stats_reference(packed, fcm, [30, 12]), rtol=0, atol=0)


# resident clusters of an NVIDIA H100 80GB HBM3 for every split the rule
# may take (chip_smoke.py's resident_table, cudaOccupancyMaxActiveClusters):
# every block of the kernel holds an SM alone, at every R up to 256, so
# this is cs -> clusters. A cluster sits inside one GPC, so 30 clusters of
# 4 fit, not 33.
H100_RESIDENT = {1: 132, 2: 66, 4: 30, 8: 15}


def h100_resident(cs, rows):
    assert rows <= tk.SMEM_MAX_T16
    return H100_RESIDENT[cs]


# (B, t16) -> (cs, R) at the serving and bucket shapes on that card
SPLIT_TABLE = [((256, 160), (1, 160)), ((1, 208), (8, 32)),
               ((64, 208), (2, 112)), ((30, 112), (4, 32)),
               ((32, 800), (8, 112)), ((1, 1600), (8, 208))]


@pytest.mark.parametrize("shape,want", SPLIT_TABLE)
def test_trunk_split_table(shape, want):
    assert tk.trunk_split(*shape, h100_resident) == want


def _cost(b, t16, cs):
    """Waves x block cost of ``cs`` blocks per utterance on the card."""
    rows = tk.rows_per_block(t16, cs)
    return -(-b // h100_resident(cs, rows)) * tk.block_cost(rows)


def test_block_cost_counts_tiles_and_passes():
    assert [tk.block_cost(r) for r in (16, 64, 112, 128, 160, 192, 208, 256)] == [
        3, 3, 4, 4, 5, 5, 8, 8]


@pytest.mark.parametrize("b", [1, 3, 30, 64, 256])
def test_trunk_split_rule(b):
    t16s = sorted({tk.trunk_geometry(t)[1] for t in range(98, 3199)})
    assert t16s[0] == 64 and t16s[-1] == 1600
    for t16 in t16s:
        cs, rows = tk.trunk_split(b, t16, h100_resident)
        assert rows % 16 == 0 and 16 <= rows <= tk.SMEM_MAX_T16, t16
        assert cs in (1, 2, 4, 8), t16
        assert cs * rows >= t16, t16            # the blocks cover the rows
        assert rows == -(-t16 // (16 * cs)) * 16, t16
        cs_min = next(c for c in (1, 2, 4, 8)
                      if -(-t16 // (16 * c)) * 16 <= tk.SMEM_MAX_T16)
        if cs > cs_min:
            # a larger cluster only where it keeps 32 rows a block and
            # costs less than the smallest (waves x block cost), or as
            # much in fewer waves
            assert rows >= 32, t16
            assert _cost(b, t16, cs) <= _cost(b, t16, cs_min), t16


@pytest.mark.parametrize("shape,want", [
    ((16, 1600), (8, 208)), ((64, 400), (2, 208)), ((128, 208), (1, 208)),
    ((100, 112), (1, 112)), ((8, 1600), (8, 208)), ((32, 800), (8, 112))])
def test_trunk_split_waits_for_no_second_wave_it_can_avoid(shape, want):
    """b16 x 1600: only clusters of 8 blocks of 208 rows fit (R <= 256);
    16 clusters take two waves of 15. b64 x 400: one wave of 64 clusters
    of 2 (R 208, cost 8) beats three waves of 4 (R 112). b128 x 208 keeps
    one block a clip (one wave, cost 8) where cs 2 takes two waves of cost
    4. b100 x 112: one wave of single blocks. b32 x 800: three waves of
    cost 4 at cs 8 beat two of cost 8 at cs 4 (5.3 against 6.3 ms on the
    card)."""
    assert tk.trunk_split(*shape, h100_resident) == want


@pytest.mark.parametrize("cluster", [3, 0, 16, 2.5])
def test_bad_cluster_size_raises(setup, cluster):
    """Checked before the device dispatch, so for CUDA tensors too."""
    _, _, packed = setup
    with pytest.raises(ValueError, match="cluster must be"):
        tk._trunk_stats_at(packed, torch.zeros(1, 98, 320), None, cluster)


@pytest.mark.parametrize("t_raw,cluster", [(1598, 1), (3198, 2)])
def test_cluster_with_too_many_rows_per_block_raises(setup, t_raw, cluster):
    _, _, packed = setup
    with pytest.raises(ValueError, match="rows per block"):
        tk._trunk_stats_at(packed, torch.zeros(1, t_raw, 320), None, cluster)


def _emulate_split(packed, fcm_out, tvalids, cs):
    """The kernel's split of each utterance's rows across ``cs`` blocks,
    in PyTorch on the CPU: row-local phases per block's rows; the x2 halo
    copied from the neighbours' edge rows; per-block partial CAM segment
    sums added in rank order; pooled mean from partial sums, then std
    from partial squared deviations. Rows are clipped at ``t_valid`` (the
    kernel's rows past it are zero)."""
    plan = tk.trunk_plan()
    wp = tk.trunk_weights(packed)
    bf = torch.bfloat16
    mm = lambda a, w: a.float() @ w.float()               # noqa: E731
    b, t_raw, _ = fcm_out.shape
    t_valid, t16 = tk.trunk_geometry(t_raw)
    rows = -(-t16 // (16 * cs)) * 16
    ranges = [(min(k * rows, t_valid), min((k + 1) * rows, t_valid))
              for k in range(cs)]
    tv = torch.as_tensor(np.asarray(tvalids)).long().clamp(1, t_valid)
    t_idx = torch.arange(t_valid)
    mask = (t_idx[None, :] < tv[:, None]).float()[..., None]

    xp = F.pad(fcm_out.to(bf), (0, 0, 2, 2 * t_valid + 1 - t_raw))
    cols = torch.cat([xp[:, k:k + 2 * t_valid - 1:2] for k in range(5)], -1)
    sa = packed["stem_aff"]
    xcat = torch.zeros((b, t_valid, 1024), dtype=bf)
    for r0, r1 in ranges:
        y = torch.relu((mm(cols[:, r0:r1], wp["w_stem"]) + sa[0])
                       * sa[1] + sa[2])
        xcat[:, r0:r1, :128] = (y * mask[:, r0:r1]).to(bf)

    n_segs = -(-t_valid // 100)
    seg_of = torch.clamp(t_idx // 100, max=n_segs - 1)
    seg_mask = torch.stack([((t_idx >= s * 100) & (t_idx < (s + 1) * 100))
                            for s in range(n_segs)]).float()
    seg_mask = seg_mask[None] * mask[None, :, :, 0].transpose(0, 1)
    seg_cnt = torch.clamp(seg_mask.sum(-1, keepdim=True), min=1)
    zeros2 = torch.zeros((b, 2, 128), dtype=bf)
    for l, spec in enumerate(plan["layers"]):
        cin, off, dil = spec["cin"], spec["lin1_off"], spec["dil"]
        la, cb = packed["lin1_aff"][l], packed["cam_bias"][l]
        ab = packed["wide_ab"][l]
        x2s = []
        for r0, r1 in ranges:
            h = torch.relu(xcat[:, r0:r1, :cin] * ab[0, :cin] + ab[1, :cin])
            x2 = torch.relu((mm(h, wp["w_lin1"][off:off + cin]) + la[0])
                            * la[1] + la[2])
            x2s.append((x2 * mask[:, r0:r1]).to(bf))
        # each block's partial segment sums, added in rank order
        seg_sum = None
        for (r0, r1), x2 in zip(ranges, x2s):
            part = seg_mask[..., r0:r1] @ x2.float()
            seg_sum = part if seg_sum is None else seg_sum + part
        mean = seg_sum.sum(1, keepdim=True) / tv[:, None, None]
        ctx = (mean + seg_sum / seg_cnt).to(bf)
        c1 = torch.relu(mm(ctx, packed["w_cam1"][l]) + cb[64:]).to(bf)
        gate = torch.sigmoid(mm(c1, packed["w_cam2"][l]) + cb[32:64]).to(bf)
        c0 = plan["blocks"][spec["block"]]["c_in"] + spec["li"] * plan["growth"]
        for k, ((r0, r1), x2) in enumerate(zip(ranges, x2s)):
            if r1 == r0:
                continue
            left = x2s[k - 1][:, -2:] if k > 0 else zeros2
            nxt = x2s[k + 1][:, :2] if k + 1 < cs else zeros2[:, :0]
            right = torch.cat([nxt, zeros2[:, nxt.shape[1]:]], 1)
            ext = torch.cat([left, x2, right], 1)
            taps = torch.cat([ext[:, 2 + (j - 1) * dil:2 + (j - 1) * dil + r1 - r0]
                              for j in range(3)], -1)
            y = mm(taps, wp["w_local"][l]) + cb[:32]
            g = gate[:, seg_of[r0:r1]].float()
            xcat[:, r0:r1, c0:c0 + 32] = (y * g * mask[:, r0:r1]).to(bf)
        if spec["li"] == plan["num_layers"][spec["block"]] - 1:
            bi = spec["block"]
            cw = plan["blocks"][bi]["c_out"]
            abt = packed["wide_ab"][plan["n_layers"] + bi]
            for r0, r1 in ranges:
                h = torch.relu(xcat[:, r0:r1, :cw] * abt[0, :cw] + abt[1, :cw])
                ht = mm(h, wp[f"w_t{bi}"]) + packed["tbias"][bi, :cw // 2]
                xcat[:, r0:r1, :cw // 2] = (ht * mask[:, r0:r1]).to(bf)

    cf, oa = plan["final_channels"], packed["out_aff"]
    n = tv[:, None].float()
    xs = [torch.relu(xcat[:, r0:r1, :cf].float() * oa[0] + oa[1])
          * mask[:, r0:r1] for r0, r1 in ranges]
    total = xs[0].sum(1)
    for x in xs[1:]:
        total = total + x.sum(1)
    mean = total / n
    sq = (((xs[0] - mean[:, None]) ** 2) * mask[:, ranges[0][0]:ranges[0][1]]).sum(1)
    for (r0, r1), x in zip(ranges[1:], xs[1:]):
        sq = sq + (((x - mean[:, None]) ** 2) * mask[:, r0:r1]).sum(1)
    return tk._unbias(torch.cat([mean, torch.sqrt(sq / n)], 1), tv)


SPLIT_TVALIDS = {298: [149, 77, 1], 398: [199, 150, 1], 1598: [799, 433, 1]}
_split_refs = {}


def _split_case(setup, t_raw):
    """FCM output (b3) and the plain version's stats for ``t_raw``."""
    if t_raw not in _split_refs:
        _, tm, packed = setup
        x = torch.from_numpy(np.random.RandomState(t_raw).randn(
            3, t_raw, 80).astype(np.float32))
        with torch.no_grad():
            fcm = tm.FCM_0(x)
        _split_refs[t_raw] = (fcm, tk.trunk_stats_reference(
            packed, fcm, SPLIT_TVALIDS[t_raw]))
    return _split_refs[t_raw]


@pytest.mark.parametrize("t_raw", [298, 398, 1598])
@pytest.mark.parametrize("cs", [1, 2, 4, 8])
def test_emulated_cluster_split_matches_plain_version(setup, t_raw, cs):
    _, _, packed = setup
    fcm, ref = _split_case(setup, t_raw)
    got = _emulate_split(packed, fcm, SPLIT_TVALIDS[t_raw], cs)
    ref, got = ref.numpy(), got.numpy()
    assert np.isfinite(got).all() and got.shape == ref.shape
    if cs == 1:
        assert rel_err(ref, got) < 1e-6
    else:
        assert cos_min(ref, got) > 0.99999
        assert rel_err(ref, got) < 1e-3
