"""The traced window: ``torch.profiler`` over the measured part of a run,
reduced to device operations, the device's busy seconds, idle gaps and
what the host was doing in them.

The harness's own spans are ``record_function`` ranges named
``bench:<name>``; ``bench:window`` bounds the window. Device operations
are the profiler's CUDA activities (kernels, copies, sets) other than the
GPU copies of those annotations."""

import contextlib
import time

import numpy as np

SPAN_PREFIX = "bench:"
WINDOW = SPAN_PREFIX + "window"


class Spans:
    """Host wall time of the harness's spans: ``{name: [seconds, ...]}``.
    Each span is also a ``record_function`` range while a trace runs."""

    def __init__(self):
        self.times = {}
        self.tracing = False

    @contextlib.contextmanager
    def span(self, name):
        rf = None
        if self.tracing:
            import torch
            rf = torch.profiler.record_function(SPAN_PREFIX + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times.setdefault(name, []).append(time.perf_counter() - t0)
            if rf is not None:
                rf.__exit__(None, None, None)

    def wrap(self, name, fn):
        def wrapped(*a, **k):
            with self.span(name):
                return fn(*a, **k)
        return wrapped


class Trace:
    """Device operations and host events of one profiler run."""

    def __init__(self, device_ops, host_ops, window):
        self.device_ops = device_ops      # [(name, start_ns, end_ns)]
        self.host_ops = host_ops          # [(name, start_ns, end_ns)]
        self.window = window              # (start_ns, end_ns)

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e9

    def kernel_seconds(self, needle):
        """Device seconds of the operations whose name holds ``needle``."""
        return sum(e - s for n, s, e in self.device_ops if needle in n) / 1e9

    def busy_intervals(self):
        lo, hi = self.window
        iv = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device_ops
                    if e > lo and s < hi)
        merged = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def gaps(self):
        lo, hi = self.window
        out, prev = [], lo
        for s, e in self.busy_intervals():
            if s > prev:
                out.append((prev, s))
            prev = max(prev, e)
        if hi > prev:
            out.append((prev, hi))
        return out

    def breakdown(self, n=10, n_gaps=400):
        """The ``n`` device operations that took most time, and the
        longest idle gaps (the ``n_gaps`` longest, summed by the innermost
        host event running at each one's midpoint)."""
        per = {}
        for name, s, e in self.device_ops:
            per[name[:160]] = per.get(name[:160], 0.0) + (e - s) / 1e9
        ops = sorted(per.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n_gaps]
        hosts = [h for h in self.host_ops if h[0] != WINDOW]
        starts = np.array([h[1] for h in hosts], np.int64)
        ends = np.array([h[2] for h in hosts], np.int64)
        by = {}
        for s, e in gaps:
            mid = (s + e) // 2
            hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
            name = "no traced host event"
            if len(hit):
                k = hit[np.argmin(ends[hit] - starts[hit])]
                name = hosts[k][0][:160]
            by[name] = by.get(name, 0.0) + (e - s) / 1e9
        idle = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}


@contextlib.contextmanager
def traced(spans, out):
    """Profile the body; ``out["trace"]`` is its ``Trace`` afterwards.
    The body is the window: it ends in a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    spans.tracing = True
    try:
        with torch.profiler.record_function(WINDOW):
            yield
            torch.cuda.synchronize()
    finally:
        spans.tracing = False
        prof.stop()
    out["trace"] = _reduce(prof)


def _reduce(prof):
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    device, host, window = [], [], None
    for ev in events:
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == DeviceType.CPU:
            if name == WINDOW:
                window = (s, e)
            host.append((name, s, e))
        elif ev.device_type() == DeviceType.CUDA and not name.startswith(SPAN_PREFIX):
            if e > s:
                device.append((name, s, e))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    return Trace(device, host, window)
