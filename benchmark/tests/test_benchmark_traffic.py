"""The generators give the same inputs for the same seed, and the same
set of sizes and arrivals for every seed, in another order."""

import numpy as np
import pytest
import torch

from benchmark import traffic_gen
from benchmark.entries.http_open_loop import schedule

T = {"clip_seconds": [2.0, 4.0], "sample_rate": 16000}
BIG = 2 ** 31 + 12345


def test_lengths_deterministic_and_stratified():
    a, b = traffic_gen.lengths(T, 64, BIG), traffic_gen.lengths(T, 64, BIG)
    c = traffic_gen.lengths(T, 64, BIG + 1)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert np.array_equal(np.sort(a), np.sort(c))
    assert a.min() > 32000 and a.max() <= 64000


def test_waves_deterministic_and_at_level():
    lens = traffic_gen.lengths(T, 4, BIG)
    a = traffic_gen.waves(lens, 64000, BIG, torch.device("cpu"))
    b = traffic_gen.waves(lens, 64000, BIG, torch.device("cpu"))
    c = traffic_gen.waves(lens, 64000, BIG + 1, torch.device("cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    for row, n in zip(a, lens):
        assert torch.all(row[n:] == 0)
        rms = float(torch.sqrt((row[:n] ** 2).mean()))
        assert abs(20 * np.log10(rms) + 20.0) < 1e-3


def test_schedule_same_arrivals_every_seed():
    a = schedule(100.0, 10.0, 512, BIG, 3)
    b = schedule(100.0, 10.0, 512, BIG, 3)
    c = schedule(100.0, 10.0, 512, BIG + 1, 3)
    assert a == b and a != c
    assert len(a) == len(c) == 1000
    # the same gaps in another order: the same span, the same spread
    for s in (a, c):
        assert abs(s[-1][0] - 10.0) < 0.5
    ga, gc = np.diff([d for d, _ in a]), np.diff([d for d, _ in c])
    assert np.std(ga) == pytest.approx(np.std(gc), rel=0.05)
