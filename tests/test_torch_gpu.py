"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version, at the shapes the main path gives it, the kernels' timers, and
the serving surface (every bucket of ``Predictor(device="cuda")`` against
the eager model, diarization, the HTTP endpoints and the micro-batcher).
Every test here is marked ``gpu`` and skips without a CUDA device. This
file imports no jax (the GPU host has none); run the card's tests there
with

    python -m pytest --noconftest tests/test_torch_gpu*.py -m gpu -q

(``tests/test_torch_gpu_workflows.py`` holds training, the workflow's
command lines, data parallelism and the trained model's diarization.)

Bars: fbank max |d| < 2e-2 and p99 < 1e-3 (``tests/test_pallas_fbank.py``),
and on hard inputs against float64 p99 <= max(1e-3, 2 x the plain version's);
trunk cos > 0.9999 and max |d| / scale < 5e-3
(``tests/test_pallas_campplus.py:47-48``), its embeddings through the head
cos > 0.9999 and max |d| < 5e-3; FCM cos > 0.9999 and max |d| / scale <
5e-2 (``tests/test_pallas_fcm.py:55-56``); embeddings of the kernel path
against the eager fp32 model at exact length cos > 0.999.
"""

import json
import os
import shutil
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torch_card import (BACKBONE_CONFS, CONFIG, ROOT, SEED, cos_min,
                        eager_embed, fbank_steps, hard_waves, held_step,
                        held_step_ok, launches, launches_since,
                        random_flax_variables, synth_corpus, train_config,
                        write_wav)
from voiceprintrecognition_paddlepaddle_torch.models import fcm_kernel as fkm
from voiceprintrecognition_paddlepaddle_torch.models import trunk_kernel as tk
from voiceprintrecognition_paddlepaddle_torch.models.campplus import CAMPPlus
from voiceprintrecognition_paddlepaddle_torch.models.convert import \
    jax_to_torch_state
from voiceprintrecognition_paddlepaddle_torch.ops import fbank_kernel as fk
from voiceprintrecognition_paddlepaddle_torch.ops import features, kaldi
from voiceprintrecognition_paddlepaddle_torch.predict import Predictor

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    import voiceprintrecognition_paddlepaddle_torch as port
    # the port of this checkout, not one installed elsewhere
    assert os.path.dirname(os.path.dirname(os.path.abspath(
        port.__file__))) == ROOT, port.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _waves(seed, b, n):
    return torch.from_numpy(
        (np.random.RandomState(seed).randn(b, n) * 0.1).astype(np.float32))


@pytest.mark.parametrize("b,n", [(8, 48000), (3, 128000), (1, 400),
                                 (256, 48000)])
def test_fbank_kernel_matches_plain_version(cuda, b, n):
    w = _waves(0, b, n).to(cuda)
    before = fk.fbank_fused.launches
    got = fk.fbank_fused(w, n_mels=80)
    torch.cuda.synchronize()
    assert fk.fbank_fused.launches == before + 1
    d = (got - fk.fbank_fused_reference(w, n_mels=80)).abs().cpu().numpy()
    assert d.max() < 2e-2 and np.percentile(d, 99) < 1e-3


@pytest.mark.parametrize("name", [
    "1e-4 noise", "1 kHz tone, then 1.5 s of silence",
    "1e-3 tone on a 0.5 DC offset", "noise, 48123 samples",
    "noise, 401 samples"])
def test_fbank_kernel_on_hard_inputs(cuda, name):
    """Against a float64 run of kaldi's steps on the card: max |d| < 2e-2
    and p99 within max(1e-3, 2 x the fp32 plain version's p99)."""
    w = torch.from_numpy(hard_waves(np.random.RandomState(1))[name]).to(cuda)
    exact = fbank_steps(fk, w)
    got = fk.fbank_fused(w).double()
    plain = fk.fbank_fused_reference(w).double()
    d = (got - exact).abs().cpu().numpy()
    p99_plain = np.percentile((plain - exact).abs().cpu().numpy(), 99)
    assert got.shape == exact.shape
    assert d.max() < 2e-2
    assert np.percentile(d, 99) <= max(1e-3, 2 * p99_plain)


def test_fbank_launches_from_many_threads(cuda):
    """Threads of a server launch the fbank kernel at different sizes at
    once (one request, a 16 s batch, rows of 48123 samples); every launch
    gives what it gives alone, bit for bit (no atomics, no state shared
    between launches)."""
    cases = []
    for seed, b, n in ((7, 1, 64000), (8, 32, 256000), (9, 3, 48123)):
        w = _waves(seed, b, n).to(cuda)
        cases.append((w, fk.fbank_fused(w)))
    torch.cuda.synchronize()
    errors, mismatches = [], []

    def worker(k):
        try:
            for i in range(9):
                w, want = cases[(k + i) % len(cases)]
                got = fk.fbank_fused(w)
                torch.cuda.current_stream().synchronize()
                if not torch.equal(got, want):
                    mismatches.append((k, i))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not mismatches, (errors[:3], mismatches[:3])


@pytest.fixture(scope="module")
def model(cuda):
    """The stock CAM++ with seeded weights and BN statistics."""
    m = CAMPPlus(80, embd_dim=192)
    m.load_state_dict(jax_to_torch_state(random_flax_variables(m, SEED)))
    return m.to(cuda).eval().requires_grad_(False)


# A ragged 4 s batch whose valid counts straddle every 16- and 64-row
# tile edge of its 208 trunk rows: at clusters of 2, 4 and 8 some ranks
# own no valid row (and at 8 the last owns no row at all).
RAGGED_4S = [1, 16, 63, 64, 65, 128, 129, 193, 199]

# (t_raw, tvalids, cluster): the default split (cluster None), then every
# cluster size at one request's length and at the 16 s and 32 s buckets;
# then b256 x 298 exact (the main path's batch, its own default split), a
# ragged 8 s batch, the ragged 4 s batch at every cluster size and b32 x
# 1598 exact at each cluster size that holds its rows. Every batch runs
# the layers whose cin (128 + 32 li) is no multiple of the kernel's
# 64-column K slice.
TRUNK_CASES = [
    (3198, None, None), (3198, [1600, 1101, 99], None), (1598, None, None),
    (1598, [800, 433, 1], None), (798, None, None),
    (798, [399, 250, 37], None), (298, None, None), (148, [74, 1, 60], None),
    (98, None, None)] + [
    (t_raw, tvalids, cluster)
    for t_raw, tvalids in ((398, [150]), (1598, [800, 433, 1]),
                           (3198, [1600, 1101, 99]), (798, [399, 250, 37]))
    for cluster in (1, 2, 4, 8)] + [(298, 256, None)] + [
    (398, RAGGED_4S, cluster) for cluster in (1, 2, 4, 8)] + [
    (1598, 32, cluster) for cluster in (4, 8)]


@pytest.mark.parametrize("t_raw,tvalids,cluster", TRUNK_CASES)
def test_trunk_kernel_matches_plain_version(cuda, model, t_raw, tvalids,
                                            cluster):
    """``tvalids`` an int: a batch of that many at exact length. The
    stats, and the embeddings the model's head gives from them."""
    packed = tk.pack_trunk(model)
    if isinstance(tvalids, int):
        b, tvalids = tvalids, None
    else:
        b = 3 if tvalids is None else len(tvalids)
    feats = torch.from_numpy(np.random.RandomState(1).randn(
        b, t_raw, 80).astype(np.float32)).to(cuda)
    fcm = model.FCM_0(feats)
    _, t16 = tk.trunk_geometry(t_raw)
    if cluster is not None and -(-t16 // (16 * cluster)) * 16 > tk.SMEM_MAX_T16:
        with pytest.raises(ValueError, match="rows per block"):
            tk._trunk_stats_at(packed, fcm, tvalids, cluster)
        return
    before = tk.trunk_stats.launches
    by_size = dict(tk.trunk_stats.cluster_launches)
    got = (tk.trunk_stats(packed, fcm, tvalids) if cluster is None
           else tk._trunk_stats_at(packed, fcm, tvalids, cluster))
    torch.cuda.synchronize()
    assert tk.trunk_stats.launches == before + 1
    if cluster is not None:
        assert tk.trunk_stats.cluster_launches[cluster] == by_size.get(cluster, 0) + 1
    ref = tk.trunk_stats_reference(packed, fcm, tvalids)
    emb, emb_ref = model.DenseBN_0(got), model.DenseBN_0(ref)
    got, ref = got.double().cpu(), ref.double().cpu()
    assert torch.isfinite(got).all()
    cos = (got * ref).sum(-1) / (got.norm(dim=-1) * ref.norm(dim=-1))
    assert float(cos.min()) > 0.9999
    assert float((got - ref).abs().max() / ref.abs().max()) < 5e-3
    assert cos_min(emb, emb_ref) > 0.9999
    assert float((emb - emb_ref).abs().max()) < 5e-3


@pytest.mark.parametrize("b,t_raw", [(256, 298), (64, 398), (1, 398),
                                     (30, 223), (32, 1598), (1, 3198)])
def test_trunk_default_split_is_trunk_split(cuda, model, b, t_raw):
    packed = tk.pack_trunk(model)
    fcm = torch.zeros((b, t_raw, 320), device=cuda)
    t_valid, t16 = tk.trunk_geometry(t_raw)
    cs, rows = tk.trunk_split(b, t16, lambda c, r: tk._max_clusters(
        c, r, t_valid, torch.cuda.current_device()))
    assert (cs, rows) == tk.default_split(b, t_raw, cuda)
    by_size = dict(tk.trunk_stats.cluster_launches)
    tk.trunk_stats(packed, fcm)
    torch.cuda.synchronize()
    assert tk.trunk_stats.cluster_launches[cs] == by_size.get(cs, 0) + 1


def test_resident_clusters_do_not_depend_on_the_valid_count(cuda):
    """``trunk_split`` keys the card's resident clusters by (cs, R) alone:
    for every split it may take (t16 from 64 to 1600 rows; a size above
    the smallest that fits keeps at least 32 rows a block), the occupancy
    query gives the same count at both ends of a t16's valid rows."""
    index = torch.cuda.current_device()
    for t16 in range(64, tk.MAX_T16 + 1, 16):
        smallest = next(c for c in tk.CLUSTER_SIZES
                        if tk.rows_per_block(t16, c) <= tk.SMEM_MAX_T16)
        for cs in tk.CLUSTER_SIZES:
            rows = tk.rows_per_block(t16, cs)
            if rows > tk.SMEM_MAX_T16 or (cs > smallest and rows < 32):
                continue
            counts = {tk._max_clusters(cs, rows, t_valid, index)
                      for t_valid in (t16 - 15, t16)}
            assert len(counts) == 1, (t16, cs, counts)


def test_trunk_phase_times_time_every_phase(cuda, model):
    """Block 0's phase stamps at the main path's b256 x 3 s: a finite,
    positive time and cycle count for every phase, each launch counted."""
    packed = tk.pack_trunk(model)
    fcm = model.FCM_0(_fcm_feats(256, 298, cuda))
    before = tk.trunk_stats.launches
    st = tk.trunk_phase_times(packed, fcm, iters=5)
    assert tk.trunk_stats.launches == before + 5
    for name in tk.TRUNK_PHASES:
        assert np.isfinite(st["ms"][name]) and st["ms"][name] > 0, st
        assert st["cycles"][name] > 0, st


def test_trunk_launches_of_different_sizes_from_many_threads(cuda, model):
    """Threads of a server launch the trunk at shapes with different
    shared-memory sizes (b1 x 398 at cs 8, b32 x 1598) at once; every
    launch runs and gives what it gives alone (the kernel's sums run in a
    fixed order, so bit for bit)."""
    packed = tk.pack_trunk(model)
    rng = np.random.RandomState(4)
    cases = []
    for b, t_raw, tvalids in ((1, 398, [150]), (32, 1598, None),
                              (3, 798, [399, 250, 37])):
        fcm = model.FCM_0(torch.from_numpy(
            rng.randn(b, t_raw, 80).astype(np.float32)).to(cuda))
        want = tk.trunk_stats(packed, fcm, tvalids)
        cases.append((fcm, tvalids, want))
    torch.cuda.synchronize()
    errors, mismatches = [], []

    def worker(k):
        try:
            for i in range(12):
                fcm, tvalids, want = cases[(k + i) % len(cases)]
                got = tk.trunk_stats(packed, fcm, tvalids)
                torch.cuda.current_stream().synchronize()
                if not torch.equal(got, want):
                    mismatches.append((k, i))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not mismatches, (errors[:3], mismatches[:3])


def _ragged_4s(model, cuda):
    """The ragged 4 s batch's FCM output in bf16, as the kernel takes it
    (so a launch allocates no copy of it)."""
    feats = torch.from_numpy(np.random.RandomState(6).randn(
        len(RAGGED_4S), 398, 80).astype(np.float32)).to(cuda)
    return model.FCM_0(feats).to(torch.bfloat16).contiguous()


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_trunk_reversed_batch_gives_the_same_stats(cuda, model, cluster):
    """The launch serves the utterances with the most valid tiles first and
    each block computes only its valid tiles: the same utterances in the
    reverse order (another launch order, other blocks) give each one's
    stats bit for bit."""
    packed = tk.pack_trunk(model)
    fcm = _ragged_4s(model, cuda)
    got = tk._trunk_stats_at(packed, fcm, RAGGED_4S, cluster)
    rev = tk._trunk_stats_at(packed, fcm.flip(0), RAGGED_4S[::-1], cluster)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(rev.flip(0), got)


def test_trunk_ignores_stale_workspace(cuda, model):
    """The concat workspace is torch.empty and the kernel skips the rows
    past each utterance's valid tiles: memory full of NaN that the caching
    allocator hands back to the next launch's workspace changes nothing."""
    packed = tk.pack_trunk(model)
    fcm = _ragged_4s(model, cuda)
    clean = tk.trunk_stats(packed, fcm, RAGGED_4S)
    torch.cuda.synchronize()
    _, t16 = tk.trunk_geometry(398)
    stale = torch.full((2, len(RAGGED_4S), t16, tk.WIDE), float("nan"),
                       dtype=torch.bfloat16, device=cuda)
    torch.cuda.synchronize()
    del stale
    got = tk.trunk_stats(packed, fcm, RAGGED_4S)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, clean)


@pytest.mark.parametrize("tvalids", [RAGGED_4S, None])
def test_trunk_counts_the_tiles_it_runs(cuda, model, tvalids):
    """``trunk_stats.tiles`` and ``.tiles_run`` grow by the launch's
    ``trunk_tiles``, computed on the host: every tile without valid
    counts."""
    packed = tk.pack_trunk(model)
    fcm = _ragged_4s(model, cuda)
    b = fcm.shape[0]
    t_valid, t16 = tk.trunk_geometry(398)
    cs, rows = tk.default_split(b, 398, cuda)
    tiles, run = tk.trunk_tiles(
        np.full(b, t_valid) if tvalids is None else tvalids, t16, cs, rows)
    before = (tk.trunk_stats.tiles, tk.trunk_stats.tiles_run)
    tk.trunk_stats(packed, fcm, tvalids)
    torch.cuda.synchronize()
    assert (tk.trunk_stats.tiles - before[0],
            tk.trunk_stats.tiles_run - before[1]) == (tiles.sum(), run.sum())
    if tvalids is None:
        assert run.sum() == tiles.sum()
    else:
        assert run.sum() < tiles.sum()


def test_trunk_rejects_buckets_beyond_32s(cuda, model):
    packed = tk.pack_trunk(model)
    with pytest.raises(ValueError, match="at most 3200 frames"):
        tk.trunk_stats(packed, torch.zeros(1, 3202, 320, device=cuda))


@pytest.mark.parametrize("bucket,valids", [
    (128000, [128000, 96000, 48000, 24000, 16000]),
    (512000, [512000, 400000, 256000, 170000])])
def test_embed_fn_holds_padded_rows_to_exact_length(cuda, model, bucket,
                                                    valids):
    """The kernel path's embed function on a ragged batch padded to the 8 s
    or the 32 s bucket: each row within cos 0.999 of the same clip
    embedded alone at its exact length."""
    embed = tk.make_campplus_masked_embed_fn(
        model, features.AudioFeaturizer("Fbank", {"sr": 16000, "n_mels": 80}))
    rng = np.random.RandomState(bucket)
    padded = np.zeros((len(valids), bucket), np.float32)
    for i, n in enumerate(valids):
        padded[i, :n] = rng.randn(n) * 0.1
    ratios = np.asarray([n / bucket for n in valids], np.float32)
    with torch.no_grad():
        got = embed(torch.from_numpy(padded).to(cuda), ratios)
        for i, n in enumerate(valids):
            exact = embed(torch.from_numpy(padded[i:i + 1, :n]).to(cuda))
            assert cos_min(exact, got[i:i + 1]) > 0.999, (i, n)


def _fcm_feats(b, t, device):
    return torch.from_numpy(np.random.RandomState(t).randn(
        b, t, 80).astype(np.float32)).to(device)


@pytest.mark.parametrize("b,t", [(8, 298), (8, 297), (4, 1598), (2, 3198),
                                 (3, 17), (256, 298), (1, 1000), (1, 5),
                                 (3, 33), (1, 1598), (64, 98), (256, 198),
                                 (1, 398), (16, 798)])
def test_fcm_kernel_matches_plain_version(cuda, model, b, t):
    packed = fkm.pack_fcm(model)
    feats = _fcm_feats(b, t, cuda)
    before = fkm.fcm_fused.launches
    got = fkm.fcm_fused(packed, feats)
    torch.cuda.synchronize()
    assert fkm.fcm_fused.launches == before + 1
    assert got.shape == (b, t, 320) and got.dtype == torch.bfloat16
    ref = fkm.fcm_reference(packed, feats).double().cpu()
    got = got.double().cpu()
    assert torch.isfinite(got).all()
    cos = float((got * ref).sum() / (got.norm() * ref.norm()))
    assert cos > 0.9999
    assert float((got - ref).abs().max()) < 5e-2 * max(1.0, float(ref.abs().max()))


def test_fcm_stage_times_time_every_launch(cuda, model):
    """The ms of each of the four launches at the 4 s bucket's b256 x 398:
    finite and positive, in the order of ``FCM_LAUNCHES``, each run
    counted."""
    packed = fkm.pack_fcm(model)
    feats = _fcm_feats(256, 398, cuda)
    before = fkm.fcm_fused.launches
    times = fkm.fcm_stage_times(packed, feats, 3)
    assert fkm.fcm_fused.launches == before + 3
    assert list(times) == [ln.name for ln in fkm.FCM_LAUNCHES]
    assert all(np.isfinite(v) and v > 0 for v in times.values()), times


@pytest.mark.parametrize("b,t", [(3, 17), (2, 1598)])
def test_fcm_ignores_stale_workspace(cuda, model, b, t):
    """The workspace (the outputs of launches A-C) and the output are
    torch.empty: a launch reads only frames and frequencies its producer
    wrote, and zero-fills the halo outside them. Memory full of NaN that
    the caching allocator hands back to the next call's output and
    workspace changes nothing."""
    packed = fkm.pack_fcm(model)
    feats = _fcm_feats(b, t, cuda)
    clean = fkm.fcm_fused(packed, feats)
    torch.cuda.synchronize()
    ws_elems = fkm._entries()[1](b, t)
    stale = [torch.full((ws_elems,), float("nan"), dtype=torch.bfloat16,
                        device=cuda),
             torch.full((b, t, 320), float("nan"), dtype=torch.bfloat16,
                        device=cuda)]
    torch.cuda.synchronize()
    del stale
    got = fkm.fcm_fused(packed, feats)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, clean)


def test_fcm_launches_from_many_threads(cuda, model):
    """Threads of a server launch the FCM kernel at shapes of different
    grids (b1 x 1598, b3 x 1000, b4 x 3198) at once; every launch gives
    what it gives alone, bit for bit (no atomics: a fixed order of sums)."""
    packed = fkm.pack_fcm(model)
    cases = []
    for b, t in ((1, 1598), (3, 1000), (4, 3198)):
        feats = _fcm_feats(b, t, cuda)
        cases.append((feats, fkm.fcm_fused(packed, feats)))
    torch.cuda.synchronize()
    errors, mismatches = [], []

    def worker(k):
        try:
            for i in range(9):
                feats, want = cases[(k + i) % len(cases)]
                got = fkm.fcm_fused(packed, feats)
                torch.cuda.current_stream().synchronize()
                if not torch.equal(got, want):
                    mismatches.append((k, i))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not mismatches, (errors[:3], mismatches[:3])


def _predictor(model, root, **kwargs):
    """``Predictor(CONFIG, device="cuda")`` on ``model``'s weights with a
    copy of the demo audio db, both under ``root``."""
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               str(root / "model.pt"))
    db = str(root / "db")
    shutil.copytree(os.path.join(ROOT, "audio_db"), db,
                    ignore=shutil.ignore_patterns("audio_indexes.bin"))
    return Predictor(CONFIG, model_path=str(root / "model.pt"),
                     audio_db_path=db, device="cuda", **kwargs)


@pytest.fixture(scope="module")
def predictor(cuda, model, tmp_path_factory):
    return _predictor(model, tmp_path_factory.mktemp("gpu_serve"))


def test_predictor_holds_every_bucket_to_the_eager_model(cuda, model,
                                                         tmp_path):
    """``Predictor(device="cuda")`` on the stock CAM++: the demo wavs
    registered, recognised and contrasted, then ``predict_batch`` over 64
    seeded clips of 1-8 s, 8 of 9-30 s (the 32 s bucket), a 15 s clip (the
    16 s bucket) and a 33 s clip. Every stage up to 32 s launches each
    kernel; the 33 s clip runs the plain model, with no FCM or trunk
    launch. Four 1-8 s clips, the 15 s and a 30 s clip embed within cos
    0.999 of the eager fp32 model at exact length."""
    pred = _predictor(model, tmp_path, threshold=-1.0)
    rng = np.random.RandomState(SEED + 6)

    def noise(seconds):
        return (rng.randn(int(seconds * 16000)) * 0.1).astype(np.float32)

    clips = [noise(rng.uniform(1.0, 8.0)) for _ in range(64)]
    long_clips = [noise(30.0)] + [noise(rng.uniform(9.0, 30.0))
                                  for _ in range(7)]
    clip_16, clip_33 = noise(15.0), noise(33.0)
    wav = lambda n: os.path.join(ROOT, "dataset", f"{n}.wav")  # noqa: E731
    rises, before = [], launches()
    assert pred.register(wav("a_1"), "speaker_a")[0]
    assert pred.register(wav("b_1"), "speaker_b")[0]
    assert all(pred.recognition(wav(n))[0] is not None for n in ("a_2", "b_2"))
    assert np.isfinite(pred.contrast(wav("a_1"), wav("a_2")))
    out = []
    for batch in (None, clips, long_clips, [clip_16], [clip_33]):
        if batch is not None:
            out.append(pred.predict_batch(batch))
        rises.append(launches_since(before))
        before = launches()
    embs, long_embs, emb_16, emb_33 = out
    assert all(min(r) >= 1 for r in rises[:-1]), rises
    assert rises[-1][1:] == [0, 0], rises
    assert embs.shape == (64, 192) and long_embs.shape == (8, 192)
    assert emb_16.shape == emb_33.shape == (1, 192)
    assert all(np.isfinite(e).all() for e in out)
    for clip, emb in ([(clips[i], embs[i]) for i in range(4)]
                      + [(clip_16, emb_16[0]), (long_clips[0], long_embs[0])]):
        want = eager_embed(model, torch.from_numpy(clip).to(cuda)[None])
        assert cos_min(want, emb[None]) > 0.999, len(clip)


def test_narrow_campplus_takes_the_plain_model_on_cuda(cuda, tmp_path):
    """A CAM++ off the stock widths (init_channels 32) serves through the
    plain model: the fbank kernel, no FCM or trunk launch, within cos
    0.9999 of the eager model."""
    narrow = CAMPPlus(80, embd_dim=32, init_channels=32)
    narrow.load_state_dict(jax_to_torch_state(
        random_flax_variables(narrow, SEED)))
    torch.save(narrow.state_dict(), str(tmp_path / "narrow.pt"))
    cfg = dict(CONFIG, model_conf=dict(
        CONFIG["model_conf"],
        model_args={"embd_dim": 32, "init_channels": 32}))
    clip = (np.random.RandomState(SEED + 8).randn(32000) * 0.1).astype(
        np.float32)
    before = launches()
    embs = Predictor(cfg, model_path=str(tmp_path / "narrow.pt"),
                     device="cuda").predict_batch([clip, clip[:20000]])
    rise = launches_since(before)
    assert embs.shape == (2, 32) and np.isfinite(embs).all()
    assert rise[0] >= 1 and rise[1:] == [0, 0], rise
    want = eager_embed(narrow.to(cuda).eval(),
                  torch.from_numpy(clip).to(cuda)[None])
    assert cos_min(want, embs[:1]) > 0.9999


def test_3s_predict_batch_launches_the_fcm_kernel_once(predictor):
    """A batch of 3 s clips (the 4 s bucket, 398 frames) takes the FCM
    kernel, one launch for the batch, and its rows hold against the same
    clips embedded one at a time."""
    rng = np.random.RandomState(16)
    clips = [(rng.randn(48000) * 0.1).astype(np.float32) for _ in range(4)]
    before = launches()
    got = predictor.predict_batch(clips)
    assert launches_since(before) == [1, 1, 1]
    one = np.stack([predictor.predict_batch([c])[0] for c in clips])
    assert got.shape == (4, 192) and np.isfinite(got).all()
    assert cos_min(got, one) > 0.9999


def _check_segments(segs, n_max=None, named=False):
    """A diarization output: ordered, non-empty {speaker, start, end}
    rows, at most ``n_max`` speakers, named from the audio db."""
    assert segs and all(set(s) == {"speaker", "start", "end"}
                        and s["end"] > s["start"] for s in segs), segs
    assert all(a["end"] <= b["start"] + 1e-9
               for a, b in zip(segs, segs[1:])), segs
    if n_max is not None:
        assert len({s["speaker"] for s in segs}) <= n_max
    if named:
        assert all(isinstance(s["speaker"], str) for s in segs)


def test_diarization_on_cuda(cuda, predictor, model):
    """Three diarizations of the demo's 28.8 s wav (no oracle count, two
    speakers, names from the audio db), each launching the three kernels;
    the chunk embeddings the clustering gets (1.5 s chunks in the 2 s
    bucket) within cos 0.999 of the eager fp32 model at exact length."""
    wav = os.path.join(ROOT, "dataset", "test_long.wav")
    seen = []
    clustering = predictor.speaker_diarize.clustering
    predictor.speaker_diarize.clustering = (
        lambda f, speaker_num=None: seen.append(f)
        or clustering(f, speaker_num=speaker_num))
    before = launches()
    try:
        for kw, n_max, named in (({}, None, False),
                                 ({"speaker_num": 2}, 2, False),
                                 ({"search_audio_db": True}, None, True)):
            _check_segments(predictor.speaker_diarization(wav, **kw), n_max,
                            named)
    finally:
        predictor.speaker_diarize.clustering = clustering
    assert min(launches_since(before)) >= 3
    segments = predictor.speaker_diarize.segments_audio(
        predictor._load_audio(wav))
    want = eager_embed(model, torch.from_numpy(
        np.stack([s[2] for s in segments])).to(cuda))
    assert seen[0].shape == tuple(want.shape)
    assert cos_min(want, seen[0]) > 0.999


def test_http_round_trip_on_cuda(predictor):
    from voiceprintrecognition_paddlepaddle_torch import serve
    from voiceprintrecognition_paddlepaddle_torch.infer_utils.micro_batcher \
        import MicroBatcher

    batcher = MicroBatcher(predictor, window_ms=20.0, max_batch=16)
    httpd = serve.ServingHTTPServer(("127.0.0.1", 0),
                                    serve.make_handler(predictor, batcher))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/embedding"
    with open(os.path.join(ROOT, "dataset", "a_1.wav"), "rb") as f:
        body = f.read()
    try:
        def post(_):
            req = urllib.request.Request(url, data=body, method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                return np.asarray(json.loads(r.read())["embedding"])

        before = tk.trunk_stats.launches
        results = [None] * 8
        threads = [threading.Thread(
            target=lambda i=i: results.__setitem__(i, post(i)))
            for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        httpd.shutdown()
        httpd.server_close()
    want = predictor.predict_batch(
        [predictor._load_audio(body).samples])[0]
    for got in results:
        assert got.shape == (192,)
        assert float(got @ want / np.linalg.norm(got)
                     / np.linalg.norm(want)) > 0.9999
    assert tk.trunk_stats.launches > before
    assert batcher.batches < batcher.items == 8


def _post(url, body=b""):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def test_http_endpoints_on_cuda(model, tmp_path):
    """Two in-process servers, one plain and one with a MicroBatcher: on
    each, /embedding within cos 0.9999 of a main-thread embed, /contrast,
    /register, /recognition, /users and /stats answer; /diarization names
    at most two speakers from the audio db; 64 concurrent /embedding
    requests of distinct 3 s clips come through the batcher in fewer
    batches, each within cos 0.9999 of its main-thread embed, every
    kernel launched; one /embedding launches each kernel once."""
    from voiceprintrecognition_paddlepaddle_torch import serve
    from voiceprintrecognition_paddlepaddle_torch.infer_utils.micro_batcher \
        import MicroBatcher

    pred = _predictor(model, tmp_path, threshold=0.6)
    rng = np.random.RandomState(SEED + 18)
    bodies = []
    for i in range(64):
        write_wav(tmp_path / "body.wav", rng.randn(48000) * 0.1)
        bodies.append((tmp_path / "body.wav").read_bytes())
    ref = np.stack([pred.predict_batch([pred._load_audio(b).samples])[0]
                    for b in bodies])
    with open(os.path.join(ROOT, "dataset", "test_long.wav"), "rb") as f:
        long_body = f.read()
    batcher = MicroBatcher(pred, window_ms=5.0, max_batch=64)
    servers, urls = [], []
    try:
        for handler in (serve.make_handler(pred),
                        serve.make_handler(pred, batcher)):
            httpd = serve.ServingHTTPServer(("127.0.0.1", 0), handler)
            servers.append(httpd)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            urls.append(f"http://127.0.0.1:{httpd.server_address[1]}")
        before = launches()
        for i, url in enumerate(urls):
            emb = _post(f"{url}/embedding", bodies[0])["embedding"]
            assert cos_min(np.asarray(emb)[None], ref[:1]) > 0.9999
            assert np.isfinite(_post(f"{url}/contrast?other=user_a/0.wav",
                                     bodies[1])["score"])
            assert _post(f"{url}/register?name=card_{i}", bodies[2])["success"]
            assert _post(f"{url}/recognition?threshold=0", bodies[2])["name"]
            _get(f"{url}/users")
            _get(f"{url}/stats")
        _check_segments(_post(f"{urls[0]}/diarization?speakers=2&search_db=1",
                              long_body)["segments"], n_max=2, named=True)
        items, batches = batcher.items, batcher.batches
        with ThreadPoolExecutor(64) as pool:
            embs = list(pool.map(lambda b: _post(f"{urls[1]}/embedding", b)
                                 ["embedding"], bodies))
        assert batcher.batches - batches < batcher.items - items == 64
        assert cos_min(np.asarray(embs), ref) > 0.9999
        assert min(launches_since(before)) >= 1
        before = launches()
        _post(f"{urls[0]}/embedding", bodies[0])
        assert launches_since(before) == [1, 1, 1]
    finally:
        for httpd in servers:
            httpd.shutdown()
            httpd.server_close()


# ---- predict_batch's staging: pinned, reused, copied without blocking -----
@pytest.fixture(scope="module")
def predictors(cuda, predictor, tmp_path_factory):
    """The stock CAM++ (the kernel path), and ERes2Net and ECAPA-TDNN at
    their configs' widths with seeded random weights (the plain path),
    on the card; ``eres2net_split`` is ERes2Net split over cuda:0 twice."""
    from voiceprintrecognition_paddlepaddle_torch.models import build_model
    from voiceprintrecognition_paddlepaddle_torch.utils.utils import \
        dict_to_object

    root = tmp_path_factory.mktemp("staging")
    out = {"campplus": predictor}
    for key in ("eres2net", "ecapa_tdnn"):
        cfg = dict(CONFIG, model_conf=BACKBONE_CONFS[key])
        model = build_model(80, dict_to_object(cfg))
        model.load_state_dict(jax_to_torch_state(
            random_flax_variables(model, 3)))
        path = str(root / f"{key}.pt")
        torch.save(model.state_dict(), path)
        out[key] = Predictor(cfg, model_path=path, device="cuda")
        assert out[key]._embed is None
    out["eres2net_split"] = Predictor(
        dict(CONFIG, model_conf=BACKBONE_CONFS["eres2net"]),
        model_path=str(root / "eres2net.pt"), device="cuda",
        data_parallel=True, devices=["cuda:0", "cuda:0"])
    return out


def _clips(seed, n):
    """An exact 4 s bucket first, then ragged 0.6-4 s clips."""
    rng = np.random.RandomState(seed)
    lens = [64000] + [int(rng.uniform(0.6, 4.0) * 16000)
                      for _ in range(n - 1)]
    return [(rng.randn(k) * 0.1).astype(np.float32) for k in lens]


@pytest.mark.parametrize("key", ["campplus", "eres2net", "ecapa_tdnn",
                                 "eres2net_split"])
def test_predict_batch_stages_in_pinned_memory(predictors, key):
    pred = predictors[key]
    clips = _clips(40, 6)
    waves, ratios = pred._stage(clips[:3], 4)
    assert waves.is_pinned() and ratios.is_pinned()
    assert pred.pinned_chunks == pred.chunks
    before = pred.chunks
    got = pred.predict_batch(clips, batch_size=4)
    assert got.shape == (6, 192) and np.isfinite(got).all()
    assert pred.chunks == before + 2
    assert pred.pinned_chunks == pred.chunks


@pytest.mark.parametrize("key", ["eres2net", "ecapa_tdnn", "eres2net_split"])
def test_plain_path_syncs_only_in_its_copy_out(predictors, key):
    """Under ``set_sync_debug_mode("error")`` a staged chunk's copies and
    model issue no synchronizing call; a whole ``predict_batch`` of two
    chunks warns of two syncs, each chunk's ``.cpu()``."""
    import warnings

    pred = predictors[key]
    clips = _clips(41, 6)
    pred.predict_batch(clips, batch_size=4)        # every shape warmed
    waves, ratios = pred._stage(clips[:4], 4)
    torch.cuda.set_sync_debug_mode("error")
    try:
        emb = pred._embed_on(0, waves, ratios)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert emb.is_cuda
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pred.predict_batch(clips, batch_size=4)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in seen
             if "synchroniz" in str(w.message)]
    assert len(syncs) == 2 * (2 if key.endswith("split") else 1), syncs


@pytest.mark.parametrize("key", ["campplus", "eres2net", "ecapa_tdnn"])
def test_four_threads_get_the_serial_embeddings(predictors, key):
    """Four threads call ``predict_batch`` at once on one Predictor, five
    times each, with different clips: every answer is bit for bit the
    serial call's, so no call's staging was reused under another's
    copy."""
    pred = predictors[key]
    inputs = [_clips(50 + t, 6) for t in range(4)]
    serial = [pred.predict_batch(c, batch_size=4) for c in inputs]
    results = [[] for _ in inputs]
    errors = []
    start = threading.Barrier(len(inputs))

    def work(t):
        try:
            start.wait(timeout=60)
            for _ in range(5):
                results[t].append(pred.predict_batch(inputs[t], batch_size=4))
        except Exception as e:             # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,))
               for t in range(len(inputs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    for want, got in zip(serial, results):
        assert len(got) == 5 and all(np.array_equal(g, want) for g in got)
    assert pred.pinned_chunks == pred.chunks


@pytest.mark.parametrize("key", ["eres2net", "ecapa_tdnn", "eres2net_split"])
def test_plain_embeddings_equal_the_zeroed_staging(predictors, key):
    """Bit for bit the embeddings of a zeroed pageable staging:
    ``np.zeros``, a blocking pageable copy and numpy ratios
    (``tests/test_torch_predict_staging.py``)."""
    from test_torch_predict_staging import zeroed_staging_embeddings

    pred = predictors[key]
    clips = _clips(42, 7)
    want = zeroed_staging_embeddings(pred, clips, 3)
    got = pred.predict_batch(clips, batch_size=3)
    assert np.array_equal(got, want)



# ---- the six other backbones and the other front ends ---------------------
@pytest.mark.parametrize("key", ["tdnn", "ecapa_tdnn", "res2net",
                                 "resnet_se", "eres2net", "eres2netv2"])
def test_backbone_serves_on_cuda(cuda, key, tmp_path):
    """Each of the six other configs at full width: Predictor(device="cuda")
    over ragged 1-8 s clips in chunks of 4 launches the fbank kernel once a
    chunk and neither CAM++ kernel, and holds every embedding within
    cos 0.999 of Predictor(device="cpu")."""
    from voiceprintrecognition_paddlepaddle_torch.models import build_model
    from voiceprintrecognition_paddlepaddle_torch.utils.utils import \
        dict_to_object

    cfg = dict(CONFIG, model_conf=BACKBONE_CONFS[key])
    model = build_model(80, dict_to_object(cfg))
    model.load_state_dict(jax_to_torch_state(random_flax_variables(model, 1)))
    torch.save(model.state_dict(), str(tmp_path / "model.pt"))
    rng = np.random.RandomState(12)
    clips = [(rng.randn(int(rng.uniform(1.0, 8.0) * 16000)) * 0.1).astype(
        np.float32) for _ in range(8)]
    pred = Predictor(cfg, model_path=str(tmp_path / "model.pt"),
                     device="cuda")
    before = (fk.fbank_fused.launches, fkm.fcm_fused.launches,
              tk.trunk_stats.launches)
    got = pred.predict_batch(clips, batch_size=4)
    torch.cuda.synchronize()
    assert (fk.fbank_fused.launches - before[0], fkm.fcm_fused.launches,
            tk.trunk_stats.launches) == (2, before[1], before[2])
    want = Predictor(cfg, model_path=str(tmp_path / "model.pt"),
                     device="cpu").predict_batch(clips, batch_size=4)
    assert got.shape == want.shape == (8, 192)
    assert cos_min(got, want) >= 0.999


@pytest.mark.parametrize("method,args", [
    ("MFCC", {}), ("MelSpectrogram", {}), ("LogMelSpectrogram", {}),
    ("Spectrogram", {}), ("Fbank", {"n_mels": 80, "window_type": "hamming"}),
    ("Fbank", {"n_mels": 80, "snip_edges": False, "use_energy": True})])
def test_feature_methods_on_cuda_match_cpu(cuda, method, args):
    """The other front ends run plain torch on the card, no fbank kernel:
    log features within 2e-2 (p99 1e-3) of the CPU, linear ones within
    1e-4 of their scale."""
    w = _waves(13, 4, 48000)
    before = fk.fbank_fused.launches
    got = features.compute_feature(w.to(cuda), method, sr=16000, **args)
    torch.cuda.synchronize()
    assert fk.fbank_fused.launches == before
    ref = features.compute_feature(w, method, sr=16000, **args)
    d = (got.cpu() - ref).abs()
    assert got.shape == ref.shape
    if method in ("MelSpectrogram", "Spectrogram"):
        assert float(d.max()) < 1e-4 * float(ref.abs().max())
    else:
        assert float(d.max()) < 2e-2
        assert float(torch.quantile(d.flatten(), 0.99)) < 1e-3


# ---- training ---------------------------------------------------------------
def test_fbank_kernel_under_autograd_and_autocast(cuda):
    """The train step featurizes under ``no_grad`` and outside autocast; the
    wrapper also gives the same fp32 features, with no graph, when called
    inside ``enable_grad`` or a bf16 ``autocast`` on a grad-free fp32
    input."""
    w = _waves(3, 8, 48000).to(cuda)
    ref = fk.fbank_fused(w, n_mels=80)
    with torch.enable_grad():
        got = fk.fbank_fused(w, n_mels=80)
        assert not got.requires_grad
    with torch.autocast("cuda", dtype=torch.bfloat16):
        amp = fk.fbank_fused(w, n_mels=80)
    torch.cuda.synchronize()
    assert got.dtype == amp.dtype == torch.float32
    assert torch.equal(got, ref) and torch.equal(amp, ref)


@pytest.fixture(scope="module")
def corpus(cuda, tmp_path_factory):
    return synth_corpus(str(tmp_path_factory.mktemp("train")), n_train=8,
                        clips=4, train_s=(1.0, 3.5), n_eval=3, enroll=1,
                        trials=2, eval_s=(2.0, 12.0))


@pytest.fixture(scope="module")
def full_corpus(cuda, tmp_path_factory):
    """64 train speakers x 8 clips of 3-5 s, 8 eval speakers x (2 enroll
    + 3 trials) clips of 3-20 s."""
    return synth_corpus(str(tmp_path_factory.mktemp("full")))


@pytest.mark.parametrize("stock", [False, True])
def test_train_step_on_cuda_matches_cpu(cuda, corpus, full_corpus, stock):
    """One train step of the stock CAM++ (b8 x 3 s of ``full_corpus``) and
    of a tiny one (init_channels 32) on the card against the CPU: the same
    weights and batch, the card in fp32 and with TF32 convs. Gates:
    ``held_step_ok``; the tiny model's without the per-leaf cos: in this
    tiny model the 1e-5 cutoff leaves leaves whose gradient is rounding
    alone among the compared ones (one read cos -0.30 while the whole
    gradient read 0.99981; NVIDIA H100 80GB HBM3, 700 W)."""
    if stock:
        cfg, _ = train_config(full_corpus,
                              **{"dataset_conf.sampler.batch_size": 8})
    else:
        cfg, _ = train_config(corpus, **{
            "dataset_conf.sampler.batch_size": 8,
            "dataset_conf.dataLoader.num_workers": 2,
            "model_conf.model_args": {"embd_dim": 32, "init_channels": 32}})
    held = held_step(cfg, cuda)
    assert held_step_ok(held, per_leaf=stock), {
        k: {n: v for n, v in h.items() if n != "grad_cos_worst"}
        if isinstance(h, dict) else h for k, h in held.items()}


def test_evaluate_takes_the_kernel_path_with_repacked_weights(cuda, corpus):
    """The stock CAM++: a train step moves the weights, then evaluate()
    runs the fbank, FCM and trunk kernels on weights packed in that call
    (its embeddings match the plain model's at exact length), and the
    model is back in train mode."""
    from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer

    cfg, _ = train_config(corpus, **{
        "dataset_conf.sampler.batch_size": 8,
        "dataset_conf.dataLoader.num_workers": 2,
        "model_conf.classifier.num_speakers": 8})
    tr = Trainer(cfg, device=cuda)
    tr._setup_dataloader(is_train=True)
    tr._setup_model(80, is_train=True)
    tr.model.train()
    tr.classifier.train()
    tr.step = 5 * len(tr.train_loader)          # the LR at its peak
    kind, data, labels, lens = next(iter(tr.train_loader))
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.train_step(kind, *(torch.from_numpy(x).to(cuda)
                          for x in (data, labels, lens)))
    assert any(not torch.equal(before[k], v)
               for k, v in tr.model.state_dict().items())
    launches = (fkm.fcm_fused.launches, tk.trunk_stats.launches)
    eer, _, _ = tr.evaluate()
    torch.cuda.synchronize()
    assert 0.0 <= eer <= 1.0 and tr.model.training
    assert fkm.fcm_fused.launches > launches[0]
    assert tk.trunk_stats.launches > launches[1]
    enroll, _ = tr.eval_embeddings["enroll"]
    tr.model.eval()
    with torch.no_grad():
        for i in range(len(tr.enroll_dataset)):
            x = torch.from_numpy(tr.enroll_dataset[i][0]).to(cuda)[None]
            f = features.apply_cmn_and_mask(kaldi.fbank(x, n_mels=80))
            assert cos_min(tr.model(f), enroll[i:i + 1]) > 0.999


def test_train_epoch_serves_best_model_and_resumes(cuda, full_corpus,
                                                   tmp_path):
    """``Trainer.train()`` of the stock CAM++ for an epoch at b64 x 3 s in
    fp32 (with the per-epoch evaluation, saving best_model) and with AMP:
    at least 4 steps, one fbank launch a step, finite losses.
    ``Predictor(best_model)`` embeds the enroll clips within cos 0.9999 of
    the trainer's evaluation; a second Trainer resumes last_model for
    epoch 2 at the schedule's step and learning rate."""
    from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer

    save = str(tmp_path / "models")
    for amp in (True, False):
        cfg, _ = train_config(full_corpus, **{"train_conf.enable_amp": amp})
        tr = Trainer(cfg, device=cuda)
        fbank, losses = [], []

        def counted(*args, _step=tr.train_step, **kwargs):
            n = fk.fbank_fused.launches
            loss, acc = _step(*args, **kwargs)
            fbank.append(fk.fbank_fused.launches - n)
            losses.append(loss)
            return loss, acc

        tr.train_step = counted
        tr.train(save_model_path="" if amp else save, log_dir="",
                 do_eval=not amp, max_epochs=1)
        assert len(losses) >= 4 and set(fbank) == {1}, fbank
        assert np.isfinite([float(x) for x in losses]).all(), losses
    enroll, _ = tr.eval_embeddings["enroll"]
    paths = [ln.split("\t")[0] for ln in tr.enroll_dataset.lines]
    best = os.path.join(save, "CAMPPlus_Fbank", "best_model")
    got = Predictor(cfg, model_path=best, device=cuda).predict_batch(
        paths, batch_size=cfg["dataset_conf"]["eval_conf"]["batch_size"])
    assert cos_min(got, enroll) > 0.9999
    tr = Trainer(cfg, device=cuda)
    tr.train(save_model_path=save, log_dir="", do_eval=False, max_epochs=2)
    with open(os.path.join(save, "CAMPPlus_Fbank", "last_model",
                           "model.state"), encoding="utf-8") as f:
        last = json.load(f)
    assert tr.step == 2 * len(tr.train_loader) and last["last_epoch"] == 2
    assert tr.optimizer.param_groups[0]["lr"] == tr.lr_schedule(tr.updates - 1)


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def second_card(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda:1")


def test_each_kernel_launches_on_its_tensors_device(second_card, model):
    """The current device is cuda:0 and every tensor lies on cuda:1: each
    wrapper launches its kernel on cuda:1 with cuda:1's stream (the CUDA
    side asks the current device), so each result matches its plain
    version there, and the current device is cuda:0 again after it."""
    import copy

    dev = second_card
    m1 = copy.deepcopy(model).to(dev)
    packed_fcm, packed = fkm.pack_fcm(m1), tk.pack_trunk(m1)
    waves = _waves(3, 2, 256000).to(dev)
    feats = _fcm_feats(2, 1598, dev)
    torch.cuda.set_device(0)
    before = (fk.fbank_fused.launches, fkm.fcm_fused.launches,
              tk.trunk_stats.launches)
    fb = fk.fbank_fused(waves, n_mels=80)
    fc = fkm.fcm_fused(packed_fcm, feats)
    st = tk.trunk_stats(packed, fc, [1600, 811])
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0
    assert (fk.fbank_fused.launches, fkm.fcm_fused.launches,
            tk.trunk_stats.launches) == tuple(n + 1 for n in before)
    assert fb.device == fc.device == st.device == dev
    d = (fb - fk.fbank_fused_reference(waves, n_mels=80)).abs().cpu().numpy()
    assert d.max() < 2e-2 and np.percentile(d, 99) < 1e-3
    ref = fkm.fcm_reference(packed_fcm, feats).double().cpu()
    got = fc.double().cpu()
    assert float((got * ref).sum() / (got.norm() * ref.norm())) > 0.9999
    ref = tk.trunk_stats_reference(packed, fc, [1600, 811]).double().cpu()
    got = st.double().cpu()
    assert float((got * ref).sum() / (got.norm() * ref.norm())) > 0.9999
    assert float((got - ref).abs().max()) < 5e-3 * max(
        1.0, float(ref.abs().max()))


def test_data_parallel_predictor_over_two_cards(second_card, model,
                                                tmp_path):
    """``Predictor(data_parallel=True)`` over every card against the one
    device ``Predictor``: 11 ragged 1-8 s clips and a 16 s clip (the FCM
    kernel), each card's share through the three kernels."""
    path = str(tmp_path / "model.pt")
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path)
    pred = Predictor(CONFIG, model_path=path, device="cuda",
                     data_parallel=True)
    assert [str(d) for d, _, _ in pred._replicas] == [
        f"cuda:{i}" for i in range(torch.cuda.device_count())]
    one = Predictor(CONFIG, model_path=path, device="cuda")
    rng = np.random.RandomState(12)
    clips = [(rng.randn(int(rng.uniform(1, 8) * 16000)) * 0.1)
             .astype(np.float32) for _ in range(11)]
    clips.append((rng.randn(16 * 16000) * 0.1).astype(np.float32))
    before = fkm.fcm_fused.launches
    got = pred.predict_batch(clips)
    assert fkm.fcm_fused.launches > before
    assert cos_min(torch.from_numpy(one.predict_batch(clips)),
                   torch.from_numpy(got)) >= 0.9999


def test_collectives_take_cuda_tensors(cuda, tmp_path):
    """The ragged gather, the cross-rank BatchNorm (forward and backward)
    and the triplet loss's gather with autograd at world 2 on CUDA tensors
    (two ranks on one card: gloo; a card each: NCCL) give what the same
    programs give on the CPU, which ``tests/test_torch_parallel.py`` holds
    against the JAX package."""
    from test_torch_parallel_ranks import launch_ranks

    rng = np.random.RandomState(0)
    bn = {name: {k: torch.from_numpy(v) for k, v in dict(
        x=rng.randn(*shape) * 2 + 0.5, dy=rng.randn(*shape),
        scale=rng.uniform(0.5, 1.5, shape[1]),
        bias=rng.randn(shape[1]) * 0.2, mean=rng.randn(shape[1]) * 0.2,
        var=rng.uniform(0.5, 1.5, shape[1])).items()}
        for name, shape in (("BC", (8, 6)), ("BCFT", (8, 4, 3, 5)))}
    labels = np.repeat(np.arange(4), 2)
    rng.shuffle(labels)
    triplet = dict(args=dict(margin=0.5, normalize_feature=True,
                             add_absolute=True, absolute_loss_weight=1.0,
                             ap_value=0.8, an_value=0.4), margin=0.3,
                   features=torch.from_numpy(rng.randn(8, 16)),
                   logits=torch.from_numpy(rng.randn(8, 6) * 3),
                   labels=torch.from_numpy(labels.astype(np.int64)))
    programs = ["ragged", "batchnorm", "triplet"]
    runs = {}
    for dev in ("cuda", "cpu"):
        (tmp_path / dev).mkdir()
        runs[dev] = launch_ranks(tmp_path / dev, programs, {
            "bn": bn, "triplet": triplet, "device": dev})
    for g, w in zip(runs["cuda"], runs["cpu"]):
        for name in ("numpy", "tensor"):
            for a, b in zip(g["ragged"][name], w["ragged"][name]):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(g["ragged"]["empty_shard"],
                                      w["ragged"]["empty_shard"])
        for name, case in w["batchnorm"].items():
            for k, v in case.items():
                torch.testing.assert_close(g["batchnorm"][name][k], v,
                                           rtol=1e-9, atol=1e-12)
        for k, v in w["triplet"].items():
            torch.testing.assert_close(g["triplet"][k], v, rtol=1e-9,
                                       atol=1e-12)
