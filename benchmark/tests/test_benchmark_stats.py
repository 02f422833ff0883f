"""The arithmetic of the end-to-end metrics: rates over all the work and
all the time of the window, percentiles over every request due, a failed
request counted as a miss at the window's length."""

import numpy as np
import pytest

from benchmark import core
from benchmark.entries.http_open_loop import summarize


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.95, 1.0])
def test_quantile_is_numpys_linear(q):
    xs = list(np.random.default_rng(1).random(101))
    assert core.quantile(xs, q) == pytest.approx(float(np.quantile(xs, q)))


def test_rate_is_all_work_over_all_time():
    assert core.rate(256 * 100, 10.0) == 2560.0
    with pytest.raises(ValueError):
        core.rate(1, 0.0)


def test_failed_request_is_a_miss_at_the_window_length():
    lat = [10.0] * 90 + [None] * 10
    res = {"latency_ms": lat, "late_ms": [0.0] * 100}
    p95, failed, backlog, late = summarize(res, 10.0)
    assert failed == 10
    assert p95 == 10000.0
    assert backlog == pytest.approx(500.5)


def test_p95_over_every_request():
    lat = list(range(1, 101))
    res = {"latency_ms": [float(x) for x in lat], "late_ms": [0.0] * 100}
    assert summarize(res, 10.0)[0] == pytest.approx(float(np.quantile(lat, 0.95)))


def test_result_line_keeps_compared_last():
    line = core.result_line(True, 1, 0, {}, {"platform": "gpu"},
                            {"x": {"value": 1.0, "limit": 2.0}}, {"device_ops": []})
    import json
    keys = list(json.loads(line))
    assert keys[-1] == "compared" and keys[:5] == [
        "correct", "attempted", "failed", "metrics", "device"]
