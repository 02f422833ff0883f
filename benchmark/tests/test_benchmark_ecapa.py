"""The ECAPA-TDNN configuration's benchmark files on the CPU: the
reference's ``forward_flops`` against a count of its convolutions made by
forward hooks, the configuration's stated widths against the reference
it builds, the 8 s traffic's clips all in the 8 s bucket, and the two
readers of the port's ``vpr.ecapa`` spans on a synthetic trace."""

import math
import threading

import pytest
import torch

from benchmark import core, traffic_gen, weights
from benchmark.trace import Trace
from voiceprintrecognition_paddlepaddle_torch.data_utils.collate import bucket_length
from voiceprintrecognition_paddlepaddle_torch.utils import tracing

CONFIG, TRAFFIC = core.files("ecapa_tdnn_c1024", "predict_8s_b64")
MS = 1_000_000
T0 = 10 ** 18


def _hook_flops(model, t):
    total = [0]

    def hook(m, _, out):
        total[0] += 2 * out.numel() * m.in_channels * math.prod(m.kernel_size) // m.groups

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv1d)]
    with torch.no_grad():
        model.eval()(torch.zeros(1, t, 80))
    for h in hooks:
        h.remove()
    return total[0]


@pytest.mark.parametrize("frames", [37, 60])
def test_forward_flops_counts_the_reference_convolutions(frames):
    ref = core.reference(CONFIG)
    model = weights.reference_model(CONFIG)
    assert ref.forward_flops(frames, None) == _hook_flops(model, frames)


def test_the_configuration_states_the_widths_it_builds():
    w = CONFIG["widths"]
    model = weights.reference_model(CONFIG)
    blocks = [getattr(model, n) for n in model.blocks]
    # the front, each block's Res2Net convs, the aggregation
    convs = [c.SamePadConv1d_0.Conv_0 for c in [model.TDNNBlock_0] + [
        b.Res2NetBlock_0.TDNNBlock_0 for b in blocks] + [model.TDNNBlock_1]]
    widths = [model.TDNNBlock_0.SamePadConv1d_0.Conv_0.out_channels] + [
        b.TDNNBlock_1.SamePadConv1d_0.Conv_0.out_channels for b in blocks] + [
        convs[-1].out_channels]
    assert widths == w["channels"]
    assert [c.kernel_size[0] for c in convs] == w["kernel_sizes"]
    assert [c.dilation[0] for c in convs] == w["dilations"]
    block = model.SERes2NetBlock_0
    assert len(block.Res2NetBlock_0.convs) + 1 == w["res2net_scale"]
    assert block.SEBlock_0.SamePadConv1d_0.Conv_0.out_channels == w["se_channels"]
    asp = model.AttentiveStatisticsPooling_0
    assert asp.TDNNBlock_0.SamePadConv1d_0.Conv_0.in_channels == 3 * w["channels"][-1]
    assert asp.TDNNBlock_0.SamePadConv1d_0.Conv_0.out_channels == w["attention_channels"]
    assert model.SamePadConv1d_0.Conv_0.out_channels == w["embd_dim"]
    assert sum(p.numel() for p in model.parameters()) == pytest.approx(20.77e6, rel=1e-3)
    assert core.reference(CONFIG).forward_flops(1, None) == pytest.approx(
        37.49e6 + 2 * (3 * 2 * 1024 * 128 + 2 * 3072 * 192), rel=1e-4)


def test_every_clip_of_the_traffic_pads_to_its_bucket():
    n = TRAFFIC["batch"] * TRAFFIC["pool_batches"]
    lens = traffic_gen.lengths(TRAFFIC, n, 2 ** 33 + 1)
    assert {bucket_length(int(x)) for x in lens} == {TRAFFIC["padded_samples"]}


@pytest.fixture
def spans():
    tracing.reset()
    yield
    tracing.reset()


def _record(items):
    with tracing.recording():
        for name, s, e in items:
            tracing.add(name, T0 + s * MS, T0 + e * MS)


def _trace(busy, window=(0, 100)):
    return Trace([("kernel", T0 + s * MS, T0 + e * MS) for s, e in busy], [],
                 (T0 + window[0] * MS, T0 + window[1] * MS))


def _read(name, tr):
    return core.reader(name).read({"trace": tr})


def test_ecapa_readers(spans):
    # two calls: the forward 10-30 and 60-76, the front and a block inside
    _record([("vpr.predict", 0, 50), ("vpr.predict.stage", 0, 8),
             ("vpr.ecapa", 10, 30), ("vpr.ecapa.front", 10, 12),
             ("vpr.ecapa.block", 12, 20), ("vpr.ecapa.res2net", 13, 17),
             ("vpr.predict", 55, 95), ("vpr.ecapa", 60, 76)])
    tr = _trace([(9, 11), (14, 16), (18, 40), (62, 100)])
    assert _read("ecapa_host_ms.predict", tr) == pytest.approx((20 + 16) / 2)
    # idle inside vpr.ecapa*: 11-12 front, 12-13 block, 13-14 res2net,
    # 16-17 res2net, 17-18 block, 60-62 the forward
    assert _read("ecapa_idle.predict", tr) == pytest.approx(7.0)
    assert _read("ecapa_idle.predict", tr) <= _read("idle.predict", tr)


def test_ecapa_readers_take_the_dispatching_thread(spans):
    _record([("vpr.ecapa", 10, 40)])
    t = threading.Thread(target=_record, args=([("vpr.ecapa.block", 0, 5), ("vpr.ecapa", 0, 5)],))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    tr = _trace([(20, 100)])
    # the other thread's forward (0-5) is shorter: its idle is not the backbone's
    assert _read("ecapa_idle.predict", tr) == pytest.approx(10.0)


@pytest.mark.parametrize("name", ["ecapa_host_ms.predict", "ecapa_idle.predict"])
def test_ecapa_readers_find_nothing_without_the_spans(name, spans, monkeypatch):
    _record([("vpr.predict", 0, 50)])
    assert _read(name, _trace([(0, 50)])) is None
    assert core.reader(name).read({}) is None
    _record([("vpr.ecapa", 10, 30)])
    assert _read(name, _trace([(0, 50)])) is not None
    monkeypatch.setattr(tracing, "dropped", 1)
    assert _read(name, _trace([(0, 50)])) is None
