"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version, at the shapes the main path gives it, and the serving surface
(diarization, an HTTP round trip through the micro-batcher) on
``Predictor(device="cuda")``. Every test here is marked ``gpu`` and skips
without a CUDA device. This file imports no jax (the GPU host has none);
run it there with

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q

Bars: fbank max |d| < 2e-2 and p99 < 1e-3 (``tests/test_pallas_fbank.py``),
and on hard inputs against float64 p99 <= max(1e-3, 2 x the plain version's);
trunk cos > 0.9999 and max |d| / scale < 5e-3
(``tests/test_pallas_campplus.py:47-48``); FCM cos > 0.9999 and
max |d| / scale < 5e-2 (``tests/test_pallas_fcm.py:55-56``).
"""

import json
import os
import shutil
import threading
import urllib.request

import numpy as np
import pytest
import torch

from voiceprintrecognition_paddlepaddle_torch.models import fcm_kernel as fkm
from voiceprintrecognition_paddlepaddle_torch.models import trunk_kernel as tk
from voiceprintrecognition_paddlepaddle_torch.models.campplus import CAMPPlus
from voiceprintrecognition_paddlepaddle_torch.ops import fbank_kernel as fk

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _waves(seed, b, n):
    return torch.from_numpy(
        (np.random.RandomState(seed).randn(b, n) * 0.1).astype(np.float32))


@pytest.mark.parametrize("b,n", [(8, 48000), (3, 128000), (1, 400)])
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
    from chip_smoke import fbank_steps, hard_waves
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
    torch.manual_seed(0)
    m = CAMPPlus(80, embd_dim=192)
    for mod in m.modules():
        if isinstance(mod, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
            mod.running_mean.normal_(0.0, 0.2)
            mod.running_var.uniform_(0.5, 1.5)
            mod.weight.data.uniform_(0.5, 1.5)
            mod.bias.data.normal_(0.0, 0.2)
    return m.to(cuda).eval().requires_grad_(False)


# A ragged 4 s batch whose valid counts straddle every 16- and 64-row
# tile edge of its 208 trunk rows: at clusters of 2, 4 and 8 some ranks
# own no valid row (and at 8 the last owns no row at all).
RAGGED_4S = [1, 16, 63, 64, 65, 128, 129, 193, 199]

# (t_raw, tvalids, cluster): the default split (cluster None), then every
# cluster size at one request's length and at the 16 s and 32 s buckets;
# then b256 x 298 exact (the main path's batch, its own default split), a
# ragged 8 s batch and the ragged 4 s batch at every cluster size. Every
# batch runs the layers whose cin (128 + 32 li) is no multiple of the
# kernel's 64-column K slice.
TRUNK_CASES = [
    (3198, None, None), (3198, [1600, 1101, 99], None), (1598, None, None),
    (1598, [800, 433, 1], None), (798, None, None),
    (798, [399, 250, 37], None), (298, None, None), (148, [74, 1, 60], None),
    (98, None, None)] + [
    (t_raw, tvalids, cluster)
    for t_raw, tvalids in ((398, [150]), (1598, [800, 433, 1]),
                           (3198, [1600, 1101, 99]), (798, [399, 250, 37]))
    for cluster in (1, 2, 4, 8)] + [(298, 256, None)] + [
    (398, RAGGED_4S, cluster) for cluster in (1, 2, 4, 8)]


@pytest.mark.parametrize("t_raw,tvalids,cluster", TRUNK_CASES)
def test_trunk_kernel_matches_plain_version(cuda, model, t_raw, tvalids,
                                            cluster):
    """``tvalids`` an int: a batch of that many at exact length."""
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
    got, ref = got.double().cpu(), ref.double().cpu()
    assert torch.isfinite(got).all()
    cos = (got * ref).sum(-1) / (got.norm(dim=-1) * ref.norm(dim=-1))
    assert float(cos.min()) > 0.9999
    assert float((got - ref).abs().max() / ref.abs().max()) < 5e-3


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


def _fcm_feats(b, t, device):
    return torch.from_numpy(np.random.RandomState(t).randn(
        b, t, 80).astype(np.float32)).to(device)


@pytest.mark.parametrize("b,t", [(8, 298), (8, 297), (4, 1598), (2, 3198),
                                 (3, 17), (256, 298), (1, 1000), (1, 5),
                                 (3, 33), (1, 1598)])
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


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def predictor(cuda, model, tmp_path_factory):
    from chip_smoke import CONFIG
    from voiceprintrecognition_paddlepaddle_torch.predict import Predictor

    root = tmp_path_factory.mktemp("gpu_serve")
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               str(root / "model.pt"))
    db = str(root / "db")
    shutil.copytree(os.path.join(ROOT, "audio_db"), db,
                    ignore=shutil.ignore_patterns("audio_indexes.bin"))
    return Predictor(CONFIG, model_path=str(root / "model.pt"),
                     audio_db_path=db, device="cuda")


def test_3s_predict_batch_launches_the_fcm_kernel_once(predictor):
    """A batch of 3 s clips (the 4 s bucket, 398 frames) takes the FCM
    kernel, one launch for the batch, and its rows hold against the same
    clips embedded one at a time."""
    from chip_smoke import row_cos

    rng = np.random.RandomState(16)
    clips = [(rng.randn(48000) * 0.1).astype(np.float32) for _ in range(4)]
    before = (fk.fbank_fused.launches, fkm.fcm_fused.launches,
              tk.trunk_stats.launches)
    got = predictor.predict_batch(clips)
    torch.cuda.synchronize()
    assert (fk.fbank_fused.launches, fkm.fcm_fused.launches,
            tk.trunk_stats.launches) == tuple(n + 1 for n in before)
    one = np.stack([predictor.predict_batch([c])[0] for c in clips])
    assert got.shape == (4, 192) and np.isfinite(got).all()
    assert float(row_cos(torch.from_numpy(got),
                         torch.from_numpy(one)).min()) > 0.9999


def test_diarization_on_cuda(predictor):
    wav = os.path.join(ROOT, "dataset", "test_long.wav")
    before = (fk.fbank_fused.launches, tk.trunk_stats.launches)
    for kw in ({}, {"speaker_num": 2}, {"search_audio_db": True}):
        out = predictor.speaker_diarization(wav, **kw)
        assert out and all(o["end"] > o["start"] for o in out)
        if kw.get("speaker_num"):
            assert len({o["speaker"] for o in out}) <= 2
        if kw.get("search_audio_db"):
            assert all(isinstance(o["speaker"], str) for o in out)
    torch.cuda.synchronize()
    assert fk.fbank_fused.launches >= before[0] + 3
    assert tk.trunk_stats.launches >= before[1] + 3


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


# ---- predict_batch's staging: pinned, reused, copied without blocking -----
@pytest.fixture(scope="module")
def predictors(cuda, predictor, tmp_path_factory):
    """The stock CAM++ (the kernel path), and ERes2Net and ECAPA-TDNN at
    their configs' widths with seeded random weights (the plain path),
    on the card; ``eres2net_split`` is ERes2Net split over cuda:0 twice."""
    from chip_smoke import BACKBONE_CONFS, CONFIG, random_flax_variables
    from voiceprintrecognition_paddlepaddle_torch.models import build_model
    from voiceprintrecognition_paddlepaddle_torch.models.convert import \
        jax_to_torch_state
    from voiceprintrecognition_paddlepaddle_torch.predict import Predictor
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
    from chip_smoke import (BACKBONE_CONFS, CONFIG, random_flax_variables,
                            row_cos)
    from voiceprintrecognition_paddlepaddle_torch.models import build_model
    from voiceprintrecognition_paddlepaddle_torch.models.convert import \
        jax_to_torch_state
    from voiceprintrecognition_paddlepaddle_torch.predict import Predictor
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
    assert float(row_cos(torch.from_numpy(got),
                         torch.from_numpy(want)).min()) >= 0.999


@pytest.mark.parametrize("method,args", [
    ("MFCC", {}), ("MelSpectrogram", {}), ("LogMelSpectrogram", {}),
    ("Spectrogram", {}), ("Fbank", {"n_mels": 80, "window_type": "hamming"}),
    ("Fbank", {"n_mels": 80, "snip_edges": False, "use_energy": True})])
def test_feature_methods_on_cuda_match_cpu(cuda, method, args):
    """The other front ends run plain torch on the card, no fbank kernel:
    log features within 2e-2 (p99 1e-3) of the CPU, linear ones within
    1e-4 of their scale."""
    from voiceprintrecognition_paddlepaddle_torch.ops import features

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


# ---- training (phase 10) ----------------------------------------------------
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
    from chip_smoke import synth_corpus

    return synth_corpus(str(tmp_path_factory.mktemp("train")), n_train=8,
                        clips=4, train_s=(1.0, 3.5), n_eval=3, enroll=1,
                        trials=2, eval_s=(2.0, 12.0))


def test_train_step_on_cuda_matches_cpu(cuda, corpus):
    """One train step of a tiny CAM++ (init_channels 32) on the card
    against the CPU: the same weights and batch, the card in fp32 and with
    TF32 convs. Gates as chip_smoke.py phase 10 (``held_step_ok``) but the
    per-leaf cos: in this tiny model the 1e-5 cutoff leaves leaves whose
    gradient is rounding alone among the compared ones (one read cos -0.30
    while the whole gradient read 0.99981; NVIDIA H100 80GB HBM3, 700 W)."""
    from chip_smoke import held_step, held_step_ok, train_config

    cfg, _ = train_config(corpus, **{
        "dataset_conf.sampler.batch_size": 8,
        "dataset_conf.dataLoader.num_workers": 2,
        "model_conf.model_args": {"embd_dim": 32, "init_channels": 32}})
    held = held_step(cfg, cuda)
    assert held_step_ok(held, per_leaf=False), {
        k: {n: v for n, v in h.items() if n != "grad_cos_worst"}
        if isinstance(h, dict) else h for k, h in held.items()}


def test_evaluate_takes_the_kernel_path_with_repacked_weights(cuda, corpus):
    """The stock CAM++: a train step moves the weights, then evaluate()
    runs the fbank, FCM and trunk kernels on weights packed in that call
    (its embeddings match the plain model's at exact length), and the
    model is back in train mode."""
    from chip_smoke import cos_min, train_config
    from voiceprintrecognition_paddlepaddle_torch.ops import features, kaldi
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
    from chip_smoke import CONFIG, cos_min
    from voiceprintrecognition_paddlepaddle_torch.predict import Predictor

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
