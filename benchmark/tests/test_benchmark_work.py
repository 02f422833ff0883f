"""The frozen work counts, pinned to the kernel table's numbers (PERF.md
§6): fbank 1.14 GFLOP at b256 x 3 s, the FCM 364.42 and the trunk 453.71
GFLOP at b256 x 298 frames, 244.27 and 304.13 at b32 x 1598."""

import math

import pytest
import torch

from benchmark import core, work


@pytest.mark.parametrize("got, want", [
    (lambda: work.fbank_work([48000] * 256)[0], 1.14e9),
    (lambda: work.fcm_work([298] * 256)[0], 364.42e9),
    (lambda: work.fcm_work([1598] * 32)[0], 244.27e9),
    (lambda: work.trunk_work([149] * 256)[0], 453.71e9),
    (lambda: work.trunk_work([799] * 32)[0], 304.13e9),
])
def test_counts_match_the_kernel_table(got, want):
    assert got() == pytest.approx(want, rel=5e-3)


def test_valid_counts_follow_the_port_rules():
    # a 3 s clip in the 4 s bucket: 398 frames, 199 trunk rows
    assert work.num_frames(64000) == 398
    assert work.valid_frames([48000], 64000)[0] == int(0.75 * 398)
    assert work.trunk_rows([48000], 64000)[0] == math.ceil(0.75 * 199)
    assert work.trunk_rows([64000], 64000)[0] == 199


def test_bound_takes_the_larger_side():
    assert work.bound_s(989e12, 989e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 989e12, 3.35e12) == pytest.approx(1.0)


def _conv_flops(model, t):
    total = [0]

    def hook(m, _, out):
        if isinstance(m, torch.nn.Linear):
            total[0] += 2 * out.numel() * m.in_features
        else:
            total[0] += 2 * out.numel() * m.in_channels * math.prod(m.kernel_size)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    with torch.no_grad():
        model.eval()(torch.zeros(1, t, 80))
    for h in hooks:
        h.remove()
    return total[0]


@pytest.mark.parametrize("t", [37, 298, 398])
def test_eres2net_count_matches_its_layers(t):
    ref = core.reference(core.files("eres2net", "predict_4s_b64")[0])
    assert ref.forward_flops(t, None) == work.eres2net_flops(t) == _conv_flops(ref.Model(), t)


def test_campplus_count_is_fcm_trunk_gates_head():
    assert work.campplus_flops(298, 149) == (
        work.fcm_work([298])[0] + work.trunk_work([149])[0]
        + work.cam_gate_flops(149) + 2 * 1024 * 192)
