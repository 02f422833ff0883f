"""The MFA-Conformer configuration's benchmark files on the CPU: the
reference's ``forward_flops`` against a count of its convolutions and
Linears made by forward hooks plus the attention's count, the
configuration's stated widths against the reference it builds, the
attention's work over the positions the port's key mask keeps, both 16 s
traffics' clips all in the 16 s bucket, and the three readers on a
synthetic trace."""

import math
import threading

import numpy as np
import pytest
import torch

from benchmark import core, traffic_gen, weights
from benchmark.trace import Trace
from benchmark.work import conformer as work
from voiceprintrecognition_paddlepaddle_torch.data_utils.collate import bucket_length
from voiceprintrecognition_paddlepaddle_torch.models.layers import length_to_mask
from voiceprintrecognition_paddlepaddle_torch.utils import tracing

CONFIG, TRAFFIC = core.files("mfa_conformer", "predict_16s_b32")
_, EMBED_16S = core.files("campplus", "embed_16s")
MS = 1_000_000
T0 = 10 ** 18


def _hook_flops(model, t):
    total = [0]

    def conv(m, _, out):
        total[0] += 2 * out.numel() * m.in_channels * math.prod(m.kernel_size) // m.groups

    def linear(m, _, out):
        total[0] += 2 * out.numel() * m.in_features

    hooks = [m.register_forward_hook(conv if isinstance(m, torch.nn.modules.conv._ConvNd)
                                     else linear)
             for m in model.modules()
             if isinstance(m, (torch.nn.modules.conv._ConvNd, torch.nn.Linear))]
    with torch.no_grad():
        model.eval()(torch.zeros(1, t, 80))
    for h in hooks:
        h.remove()
    return total[0]


@pytest.mark.parametrize("frames", [37, 60])
def test_forward_flops_counts_the_reference_products(frames):
    ref = core.reference(CONFIG)
    model = weights.reference_model(CONFIG)
    n = (frames - 1) // 2
    assert ref.forward_flops(frames, None) == _hook_flops(model, frames) + ref.attention_flops(n)
    assert ref.attention_flops(n) == 6 * 4 * (2 * n * n * 128 + 2 * n * n * 64)


def test_the_configuration_states_the_widths_it_builds():
    w = CONFIG["widths"]
    model = weights.reference_model(CONFIG)
    assert model.Subsampling_0.Conv_0.out_channels == w["output_size"]
    assert model.Subsampling_0.Dense_0.in_features == w["output_size"] * 39
    assert len(model.blocks) == w["num_blocks"]
    block = model.ConformerBlock_0
    attn = block.RelPositionAttention_0
    assert (attn.h, attn.dk) == (w["attention_heads"], w["d_k"])
    assert attn.Dense_4.bias is None
    assert block.FeedForward_0.Dense_0.out_features == w["linear_units"]
    conv = block.ConvModule_0
    assert conv.Conv_0.out_channels == 2 * w["output_size"]
    assert conv.Conv_1.kernel_size[0] == w["cnn_module_kernel"]
    assert conv.Conv_1.groups == w["output_size"]
    assert model.LayerNorm_0.weight.numel() == w["mfa_channels"]
    asp = model.AttentiveStatisticsPooling_0
    assert asp.TDNNBlock_0.SamePadConv1d_0.Conv_0.in_channels == 3 * w["mfa_channels"]
    assert asp.TDNNBlock_0.SamePadConv1d_0.Conv_0.out_channels == w["attention_channels"]
    assert model.Dense_0.out_features == w["embd_dim"]
    # the sum of the stated widths, not the paper's 20.5 M: the configuration's
    # assumed.parameters gives the count by layer and the gap left untraced
    assert sum(p.numel() for p in model.parameters()) == 19_759_424
    assert core.reference(CONFIG).forward_flops(1598, None) == pytest.approx(36.49e9, rel=1e-3)


def test_attention_work_counts_the_positions_the_port_keeps():
    padded = TRAFFIC["padded_samples"]
    t = 798                                  # 1,598 frames after the stride 2
    assert work.valid_positions([padded], padded).tolist() == [t]
    lens = traffic_gen.lengths(TRAFFIC, 64, 2 ** 33 + 7)
    ratios = torch.from_numpy((lens / padded).astype(np.float32))
    kept = length_to_mask(ratios * t, t).sum(1).numpy()
    assert np.array_equal(work.valid_positions(lens, padded), kept)
    flops, nbytes = work.attention_work(lens, padded)
    assert nbytes == 6 * 4 * 4 * 384 * int(kept.sum())
    # a full 16 s clip: 6 blocks x 4 heads of 798 x 798 scores over 128
    # and a weighted sum over 64
    assert work.attention_work([padded], padded) == (
        6 * 4 * (2 * t * t * 128 + 2 * t * t * 64), 6 * 4 * 4 * 384 * t)
    assert flops < 64 * work.attention_work([padded], padded)[0]


@pytest.mark.parametrize("traffic", [TRAFFIC, EMBED_16S], ids=["predict_16s_b32", "embed_16s"])
def test_every_clip_of_the_traffic_pads_to_the_16s_bucket(traffic):
    n = traffic["batch"] * traffic["pool_batches"]
    lens = traffic_gen.lengths(traffic, n, 2 ** 33 + 1)
    assert {bucket_length(int(x)) for x in lens} == {traffic["padded_samples"]} == {256000}


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
    return Trace([(name, T0 + s * MS, T0 + e * MS) for name, s, e in busy], [],
                 (T0 + window[0] * MS, T0 + window[1] * MS))


def _read(name, tr, **reading):
    return core.reader(name).read({"trace": tr, **reading})


def test_conformer_readers(spans):
    # two calls: the forward 10-30 and 60-76, the subsampling and a block inside
    _record([("vpr.predict", 0, 50), ("vpr.predict.stage", 0, 8),
             ("vpr.conformer", 10, 30), ("vpr.conformer.subsample", 10, 12),
             ("vpr.conformer.block", 12, 20), ("vpr.conformer.attn", 13, 17),
             ("vpr.predict", 55, 95), ("vpr.conformer", 60, 76)])
    tr = _trace([("k", 9, 11), ("k", 14, 16), ("k", 18, 40), ("k", 62, 100)])
    assert _read("conformer_host_ms.predict", tr) == pytest.approx((20 + 16) / 2)
    # idle inside vpr.conformer*: 11-12 subsample, 12-13 block, 13-14 attn,
    # 16-17 attn, 17-18 block, 60-62 the forward
    assert _read("conformer_idle.predict", tr) == pytest.approx(7.0)
    assert _read("conformer_idle.predict", tr) <= _read("idle.predict", tr)


def test_conformer_readers_take_the_dispatching_thread(spans):
    _record([("vpr.conformer", 10, 40)])
    t = threading.Thread(target=_record, args=([("vpr.conformer.block", 0, 5),
                                                ("vpr.conformer", 0, 5)],))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    tr = _trace([("k", 20, 100)])
    assert _read("conformer_idle.predict", tr) == pytest.approx(10.0)


@pytest.mark.parametrize("name", ["conformer_host_ms.predict", "conformer_idle.predict"])
def test_conformer_readers_find_nothing_without_the_spans(name, spans, monkeypatch):
    _record([("vpr.predict", 0, 50)])
    assert _read(name, _trace([("k", 0, 50)])) is None
    assert core.reader(name).read({}) is None
    _record([("vpr.conformer", 10, 30)])
    assert _read(name, _trace([("k", 0, 50)])) is not None
    monkeypatch.setattr(tracing, "dropped", 1)
    assert _read(name, _trace([("k", 0, 50)])) is None


def test_attn_roofline_reads_the_fused_kernel_alone():
    lens, padded = np.array([256000, 160000]), 256000
    tr = _trace([("fmha_cutlassF_f32_aligned_64x64_rf_sm80(AttentionKernel)", 0, 2),
                 ("fmha_cutlassF_f32_aligned_64x64_rf_sm80(AttentionKernel)", 10, 12),
                 ("ampere_sgemm_128x64_tn", 2, 10)])
    reading = {"work": [(lens, padded), (lens, padded)]}
    flops, nbytes = work.attention_work(lens, padded)
    bound = max(flops / 495e12, nbytes / 3.35e12)
    assert _read("attn_roofline.predict", tr, **reading) == pytest.approx(
        100 * 2 * bound / 4e-3)
    # no fused attention kernel in the trace, or no work: nothing to read
    assert _read("attn_roofline.predict", _trace([("ampere_sgemm", 0, 5)]), **reading) is None
    assert _read("attn_roofline.predict", tr, work=[]) is None
