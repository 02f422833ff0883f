"""The readers of the port's spans (``metrics/_program.py`` and the six
metrics that use it) on a synthetic trace with synthetic spans: the
attribution of idle time covers every gap and agrees with a count made
instant by instant, each ``*_idle`` share is at most the cell's
``idle.*`` share, the sync count keeps only events inside ``vpr.embed``,
and a window with no spans, or a tracer that dropped spans, reads None."""

import random
import threading

import pytest

from benchmark import core
from benchmark.metrics import _program
from benchmark.trace import Trace
from voiceprintrecognition_paddlepaddle_torch.utils import tracing

SIX = ["syncs_per_batch.embed", "embed_fn_idle.embed", "entry_host_ms.predict",
       "entry_idle.predict", "loader_load_ms.train", "step_host_ms.train"]
MS = 1_000_000
T0 = 10 ** 18            # the clock's scale: Unix-epoch nanoseconds


@pytest.fixture(autouse=True)
def clean_tracer():
    tracing.reset()
    yield
    tracing.reset()


def record(spans, thread=False):
    """``(name, start, end, id)`` in ms from ``T0``, recorded through the
    tracer, on a thread of their own if ``thread``."""
    def put():
        with tracing.recording():
            for name, s, e, i in spans:
                tracing.add(name, T0 + s * MS, T0 + e * MS, id=i)
    if thread:
        t = threading.Thread(target=put)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    else:
        put()


def trace(busy, host=(), window=(0, 100)):
    """Busy device intervals and host events in ms from ``T0``."""
    ms = lambda xs: [(n, T0 + s * MS, T0 + e * MS) for n, s, e in xs]  # noqa: E731
    return Trace(ms(("kernel", s, e) for s, e in busy), ms(host),
                 (T0 + window[0] * MS, T0 + window[1] * MS))


def read(name, tr):
    return core.reader(name).read({"trace": tr})


def embed_cell():
    """Three embed calls, each with a sync inside; one sync outside."""
    calls = []
    for k, at in enumerate((10, 40, 70)):
        calls += [("vpr.embed", at, at + 20, None),
                  ("vpr.embed.featurize", at, at + 5, None),
                  ("vpr.embed.trunk", at + 5, at + 18, None)]
    record(calls)
    host = [("cudaStreamSynchronize", 12, 13), ("cudaStreamSynchronize", 42, 44),
            ("cudaMemcpy", 75, 76), ("cudaMemcpyAsync", 15, 16),
            ("cudaStreamSynchronize", 35, 36), ("cudaEventSynchronize", 95, 96)]
    return trace([(0, 11), (14, 28), (31, 41), (45, 72), (80, 100)], host)


def test_sync_count_keeps_only_events_inside_the_embed_function():
    tr = embed_cell()
    # 12 and 42 (stream), 75 (memcpy); not the async copy, not 35 or 95
    assert read("syncs_per_batch.embed", tr) == pytest.approx(3 / 3)


def test_embed_idle_is_the_idle_inside_the_embed_function():
    tr = embed_cell()
    # calls at 10-30, 40-60, 70-90 (featurize the first 5 ms, the trunk
    # the next 13); gaps 11-14 and 41-45 in featurize, 28-31 in the bare
    # call to 30 then outside, 72-80 in featurize to 75 then the trunk
    assert read("embed_fn_idle.embed", tr) == pytest.approx(17.0)
    assert read("idle.embed", tr) == pytest.approx(18.0)
    split = _program.idle_by_span(tr, _program.window_spans({"trace": tr}),
                                  threading.get_ident())
    assert split == pytest.approx({"vpr.embed.featurize": 0.010,
                                   "vpr.embed.trunk": 0.005, "vpr.embed": 0.002,
                                   None: 0.001})


def predict_cell():
    record([("vpr.predict", 0, 40, 0), ("vpr.predict.stage", 1, 6, None),
            ("vpr.predict.copy_in", 6, 9, None), ("vpr.predict.model", 9, 30, None),
            ("vpr.predict.copy_out", 30, 39, None),
            ("vpr.predict", 50, 90, 1), ("vpr.predict.stage", 50, 57, None),
            ("vpr.predict.copy_in", 57, 60, None), ("vpr.predict.model", 60, 80, None),
            ("vpr.predict.copy_out", 80, 88, None)])
    return trace([(8, 34), (58, 85)])


def test_entry_readers():
    tr = predict_cell()
    assert read("entry_host_ms.predict", tr) == pytest.approx((5 + 3 + 7 + 3) / 2)
    # idle in stage/copies: 1-8 (7), 34-39 (5), 50-58 (8), 85-88 (3)
    assert read("entry_idle.predict", tr) == pytest.approx(23.0)
    assert read("entry_idle.predict", tr) <= read("idle.predict", tr)


def test_train_readers_take_the_stepping_thread_and_the_loader_threads():
    record([("vpr.train.step", 10, 40, 1), ("vpr.train.forward", 12, 20, None),
            ("vpr.train.step", 50, 70, 2), ("vpr.loader.wait", 5, 9, 0)])
    record([("vpr.loader.load", 1, 31, 0), ("vpr.loader.load", 20, 40, 1),
            ("vpr.train.step", 80, 81, 9)], thread=True)
    tr = trace([(15, 60)])
    assert read("step_host_ms.train", tr) == pytest.approx(25.0)
    assert read("loader_load_ms.train", tr) == pytest.approx(25.0)


def test_spans_outside_the_window_are_left_out():
    record([("vpr.loader.load", -5, 10, 0), ("vpr.loader.load", 90, 110, 1),
            ("vpr.loader.load", 20, 24, 2)])
    assert read("loader_load_ms.train", trace([], window=(0, 100))) == pytest.approx(4.0)


@pytest.mark.parametrize("name", SIX)
def test_a_window_with_no_spans_reads_none(name):
    record([("vpr.embed", 200, 210, None), ("vpr.predict", 200, 210, 0),
            ("vpr.train.step", 200, 210, 0), ("vpr.loader.load", 200, 210, 0)])
    tr = trace([(0, 50)], [("cudaStreamSynchronize", 10, 11)])
    assert read(name, tr) is None
    assert core.reader(name).read({}) is None


@pytest.mark.parametrize("name", SIX)
def test_a_tracer_that_dropped_spans_reads_none(name, monkeypatch):
    tr = embed_cell()
    predict_cell()
    record([("vpr.train.step", 1, 2, 0), ("vpr.loader.load", 1, 2, 0)])
    assert read(name, tr) is not None
    monkeypatch.setattr(tracing, "dropped", 1)
    assert read(name, tr) is None


def _nested(rng, lo, hi, depth, out):
    """Random properly nested intervals inside [lo, hi)."""
    t = lo
    while depth and t < hi - 2:
        s = rng.randint(t, hi - 2)
        e = rng.randint(s + 1, min(hi, s + 40))
        if rng.random() < 0.8:
            out.append((f"vpr.d{depth}", s, e))
            _nested(rng, s, e, depth - 1, out)
        t = e


@pytest.mark.parametrize("seed", range(6))
def test_attribution_covers_every_gap_and_matches_a_count_by_instant(seed):
    rng = random.Random(seed)
    spans = []
    _nested(rng, 0, 200, 3, spans)
    busy = []
    t = rng.randint(0, 5)
    while t < 200:
        s = t + rng.randint(0, 6)
        busy.append((s, s + rng.randint(1, 9)))
        t = busy[-1][1]
    record([(n, s, e, None) for n, s, e in spans])
    record([("vpr.other", 0, 200, None)], thread=True)
    tr = trace(busy, window=(0, 200))
    got = _program.idle_by_span(tr, _program.window_spans({"trace": tr}),
                                threading.get_ident())
    idle_s = tr.window_s - tr.busy_s
    assert sum(got.values()) == pytest.approx(idle_s)
    want = {}
    for u in range(200):              # 1 ms instants
        if any(s <= u < e for s, e in busy):
            continue
        # the innermost: latest start, then shortest, then the later
        # recorded of two equal spans (the child)
        inner = [(x[1], -x[2], k, x[0]) for k, x in enumerate(spans)
                 if x[1] <= u < x[2]]
        name = max(inner)[3] if inner else None
        want[name] = want.get(name, 0.0) + 1e-3
    assert got == pytest.approx(want)
