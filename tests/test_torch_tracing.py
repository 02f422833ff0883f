"""PyTorch port, the tracer (``utils.tracing``): off by default and then
free (the shared no-op, no allocation); on inside ``recording()`` and
while a ``torch.profiler`` run records, from every thread; nested spans
with their parent, thread and ``id``; the profiler's clock; the cap; and
the spans that ``Predictor.predict_batch`` (with the kernel path's embed
function, and on the plain path on one device and two), the ``DataLoader``, ``Trainer.train_step`` and the
``MicroBatcher`` record, on small CPU inputs."""

import inspect
import os
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from test_torch_helpers import speaker_corpus, train_configs
from torch_card import tone
from voiceprintrecognition_paddlepaddle_torch.data_utils.loader import \
    DataLoader
from voiceprintrecognition_paddlepaddle_torch.infer_utils.micro_batcher \
    import MicroBatcher
from voiceprintrecognition_paddlepaddle_torch.models import build_model
from voiceprintrecognition_paddlepaddle_torch.predict import Predictor
from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer
from voiceprintrecognition_paddlepaddle_torch.utils import tracing
from voiceprintrecognition_paddlepaddle_torch.utils.config import load_yaml
from voiceprintrecognition_paddlepaddle_torch.utils.utils import \
    dict_to_object

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def clean_tracer():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    tracing.reset()
    yield
    tracing.reset()
    torch.set_num_threads(n)


def _by_name(spans):
    out = {}
    for k, s in enumerate(spans):
        out.setdefault(s.name, []).append(k)
    return out


def test_off_by_default_is_the_shared_no_op_and_allocates_nothing():
    assert not tracing._on()
    assert tracing.span("vpr.a") is tracing.span("vpr.b", id=3) is tracing._OFF
    with tracing.span("vpr.a"):
        pass
    tracing.add("vpr.a", 1, 2)
    assert tracing.spans() == []
    here = tracing.__file__
    tracemalloc.start()
    try:
        for _ in range(100):                 # warm every free list
            with tracing.span("vpr.a", id=1):
                pass
        before = tracemalloc.take_snapshot()
        for _ in range(10000):
            with tracing.span("vpr.a", id=1):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == here and d.size_diff > 0]
    assert grown == []
    assert tracing.spans() == []


def test_recording_keeps_nested_spans_with_parent_thread_and_id():
    def worker():
        with tracing.span("vpr.w", id=9):
            with tracing.span("vpr.w.part"):
                pass

    with tracing.recording():
        with tracing.span("vpr.outer", id=1):
            with tracing.span("vpr.outer.a"):
                with tracing.span("vpr.outer.a.x", id=2):
                    pass
            with tracing.span("vpr.outer.b"):
                pass
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
        tracing.add("vpr.added", 5, 6, id=1)
    assert not t.is_alive()
    with tracing.span("vpr.after"):          # off again
        pass
    spans = tracing.spans()
    by = _by_name(spans)
    assert "vpr.after" not in by
    main = threading.get_ident()
    (outer,), (a,), (x,), (b,) = (by[n] for n in (
        "vpr.outer", "vpr.outer.a", "vpr.outer.a.x", "vpr.outer.b"))
    assert spans[outer].parent is None and spans[outer].id == 1
    assert spans[a].parent == outer and spans[b].parent == outer
    assert spans[x].parent == a and spans[x].id == 2
    assert all(spans[k].thread == main for k in (outer, a, x, b))
    (w,), (part,) = by["vpr.w"], by["vpr.w.part"]
    assert spans[w].thread != main and spans[w].id == 9
    assert spans[w].parent is None and spans[part].parent == w
    (added,) = by["vpr.added"]
    assert spans[added][1:3] == (5, 6) and spans[added].parent is None
    starts = [s.start_ns for s in spans]
    assert starts == sorted(starts)
    assert all(s.end_ns >= s.start_ns for s in spans)


def test_a_profiler_run_turns_recording_on_for_every_thread():
    seen = {}

    def worker():
        seen["worker"] = tracing._on()
        with tracing.span("vpr.worker"):
            pass

    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        seen["main"] = tracing._on()
        with tracing.span("vpr.main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    finally:
        prof.stop()
    assert not t.is_alive()
    assert seen == {"main": True, "worker": True}
    assert not tracing._on()
    by = _by_name(tracing.spans())
    assert set(by) == {"vpr.main", "vpr.worker"}


def test_the_profilers_flag_is_read_in_one_function_only():
    """Nothing else switches recording: no environment variable, no
    configuration key; the profiler's private flag is read by ``_on``
    alone."""
    with open(tracing.__file__, encoding="utf-8") as f:
        src = f.read()
    assert src.count("_is_profiler_enabled") == 1
    assert "_is_profiler_enabled" in inspect.getsource(tracing._on)
    assert "environ" not in src and "record_function" not in src.replace(
        "``record_function``", "")


def test_spans_share_the_profilers_clock():
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        with tracing.span("vpr.clock"):
            with record_function("test.clock"):
                time.sleep(0.005)
    finally:
        prof.stop()
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "test.clock"]
    (s,) = tracing.spans()
    ev_start, ev_end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    # the span encloses the range, within a millisecond either side
    assert s.start_ns - 1_000_000 <= ev_start < ev_end <= s.end_ns + 1_000_000
    assert s.start_ns > ev_start - 1_000_000 and s.end_ns < ev_end + 1_000_000
    assert ev.duration_ns() >= 5_000_000


def test_the_cap_counts_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 5)
    with tracing.recording():
        for k in range(8):
            with tracing.span("vpr.s", id=k):
                pass
        tracing.add("vpr.s", 1, 2)
    assert len(tracing.spans()) == 5 and tracing.dropped == 4
    tracing.reset()
    assert tracing.spans() == [] and tracing.dropped == 0


@pytest.fixture(scope="module")
def campplus_predictor(tmp_path_factory):
    """The stock CAM++ (``configs/cam++.yml``) with torch's initial
    weights: ``Predictor(device="cpu")`` takes the kernel path."""
    cfg = load_yaml(os.path.join(ROOT, "configs", "cam++.yml"))
    torch.manual_seed(0)
    model = build_model(80, dict_to_object(cfg))
    path = tmp_path_factory.mktemp("tracing") / "model.pt"
    torch.save(model.state_dict(), str(path))
    pred = Predictor(cfg, model_path=str(path), device="cpu")
    assert pred._embed is not None
    return pred


def test_predict_batch_records_the_entry_and_the_embed_function(
        campplus_predictor):
    clips = [tone(150, 0.8, 1), tone(220, 1.1, 2), tone(300, 0.9, 3)]
    with tracing.recording():
        campplus_predictor.predict_batch(clips, batch_size=2)
        campplus_predictor.predict_batch(clips[:1])
    spans = tracing.spans()
    by = _by_name(spans)
    calls = by["vpr.predict"]
    assert len(calls) == 2
    first, second = (spans[k] for k in calls)
    assert second.id == first.id + 1
    for name in ("vpr.predict.stage", "vpr.predict.copy_in",
                 "vpr.predict.model", "vpr.predict.copy_out", "vpr.embed"):
        assert len(by[name]) == 3, name        # one per chunk: 2 + 1
    for name in ("vpr.predict.stage", "vpr.predict.copy_in",
                 "vpr.predict.model", "vpr.predict.copy_out"):
        assert all(spans[spans[k].parent].name == "vpr.predict"
                   for k in by[name])
    assert all(spans[spans[k].parent].name == "vpr.predict.model"
               for k in by["vpr.embed"])
    for part in ("featurize", "fcm", "trunk", "head"):
        ks = by[f"vpr.embed.{part}"]
        assert len(ks) == 3 and all(
            spans[spans[k].parent].name == "vpr.embed" for k in ks), part
    # within a call: stage, copy_in, model, copy_out in that order
    kids = sorted((s.start_ns, s.name) for s in spans
                  if s.parent == calls[1])
    assert [n for _, n in kids] == ["vpr.predict.stage", "vpr.predict.copy_in",
                                    "vpr.predict.model", "vpr.predict.copy_out"]


@pytest.mark.parametrize("split", [False, True], ids=["one", "split"])
def test_predict_batch_records_the_entry_on_the_plain_path(tmp_path, split):
    """ERes2Net (the plain path), on one device and split over two: the
    four ``vpr.predict.*`` spans that ``entry_host_ms.predict`` and
    ``entry_idle.predict`` read keep their names and nesting, one
    ``.stage`` and ``.copy_out`` a chunk and one ``.copy_in`` and
    ``.model`` a device's share, in that order."""
    cfg = load_yaml(os.path.join(ROOT, "configs", "eres2net.yml"))
    cfg["model_conf"]["model_args"] = dict(
        embd_dim=16, m_channels=8, num_blocks=(1, 1, 1, 1))
    torch.manual_seed(0)
    path = str(tmp_path / "model.pt")
    torch.save(build_model(80, dict_to_object(cfg)).state_dict(), path)
    kw = dict(data_parallel=True, devices=["cpu", "cpu"]) if split else {}
    pred = Predictor(cfg, model_path=path, device="cpu", **kw)
    assert pred._embed is None
    clips = [tone(150, 0.8, 1), tone(220, 1.1, 2), tone(300, 0.9, 3),
             tone(180, 1.3, 4)]
    with tracing.recording():
        pred.predict_batch(clips, batch_size=2)
    spans = tracing.spans()
    by = _by_name(spans)
    (call,) = by["vpr.predict"]
    shares = 2 if split else 1
    want = {"vpr.predict.stage": 2, "vpr.predict.copy_in": 2 * shares,
            "vpr.predict.model": 2 * shares, "vpr.predict.copy_out": 2}
    for name, n in want.items():
        assert len(by[name]) == n, name
        assert all(spans[k].parent == call for k in by[name]), name
    kids = [n for _, n in sorted((s.start_ns, s.name) for s in spans
                                 if s.parent == call)]
    chunk = (["vpr.predict.stage"]
             + ["vpr.predict.copy_in", "vpr.predict.model"] * shares
             + ["vpr.predict.copy_out"])
    assert kids == chunk * 2


def test_the_loaders_load_and_wait_spans_share_batch_ids():
    class Items:
        def __getitem__(self, j):
            time.sleep(0.001)
            return np.full(4, j, np.float32)

    batches = [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9]]
    loader = DataLoader(Items(), batches, collate_fn=np.stack, num_workers=3)
    with tracing.recording():
        got = [b[:, 0].tolist() for b in loader]
    assert got == [[float(a), float(b)] for a, b in batches]
    spans = tracing.spans()
    loads = {s.id: s for s in spans if s.name == "vpr.loader.load"}
    waits = {s.id: s for s in spans if s.name == "vpr.loader.wait"}
    assert sorted(loads) == sorted(waits) == list(range(len(batches)))
    main = threading.get_ident()
    assert all(s.thread == main for s in waits.values())
    assert all(s.thread != main for s in loads.values())
    # a batch is handed over after its load ends
    assert all(waits[i].end_ns >= loads[i].end_ns for i in loads)


def test_train_step_records_its_phases(tmp_path):
    lists = speaker_corpus(tmp_path, n_speakers=2, n_utts=4)
    cfg = train_configs(lists, model_args={"embd_dim": 16, "channels": 16,
                                           "pooling_type": "TSP"},
                        batch_size=4, num_speakers=2)
    tr = Trainer(cfg, device="cpu")
    tr._setup_dataloader(is_train=True)
    tr._setup_model(tr.audio_featurizer.feature_dim, is_train=True)
    tr.model.train()
    tr.classifier.train()
    kind, data, labels, lens = next(iter(tr.train_loader))
    tr.step = 1
    with tracing.recording():
        for _ in range(2):
            batch = [tr._to_device(x) for x in (data, labels, lens)]
            loss, _ = tr.train_step(kind, *batch)
    assert np.isfinite(float(loss))
    spans = tracing.spans()
    by = _by_name(spans)
    assert len(by["vpr.train.to_device"]) == 6
    steps = by["vpr.train.step"]
    assert [spans[k].id for k in steps] == [1, 2]
    for part in ("featurize", "forward", "backward", "optimizer"):
        ks = by[f"vpr.train.{part}"]
        assert [spans[k].parent for k in ks] == steps, part
    kids = sorted((s.start_ns, s.name) for s in spans if s.parent == steps[0])
    assert [n for _, n in kids] == ["vpr.train.featurize", "vpr.train.forward",
                                    "vpr.train.backward", "vpr.train.optimizer"]


def test_micro_batcher_records_each_requests_wait_and_its_batch():
    class Stub:
        calls = 0

        def predict_batch(self, clips, batch_size=32):
            Stub.calls += 1
            time.sleep(0.002)
            return np.stack([np.full(3, len(c), np.float32) for c in clips])

    batcher = MicroBatcher(Stub(), window_ms=100.0, max_batch=8)
    with tracing.recording():
        futs = [batcher.embed_async(np.zeros(100 + k, np.float32))
                for k in range(5)]
        out = [f.result(timeout=30) for f in futs]
    assert [o[0] for o in out] == [100.0 + k for k in range(5)]
    assert batcher.items == 5
    spans = tracing.spans()
    waits = [s for s in spans if s.name == "vpr.batcher.wait"]
    batches = {s.id: s for s in spans if s.name == "vpr.batcher.batch"}
    assert len(waits) == 5 and len(batches) == batcher.batches == Stub.calls
    for w in waits:
        b = batches[w.id]
        assert w.end_ns <= b.start_ns and w.start_ns <= w.end_ns
        assert b.thread == w.thread != threading.get_ident()
