"""Shared by the readers of the port's own spans (``utils.tracing`` in the
port): the spans of the traced window, and every idle gap of the device
split among the spans the dispatching thread had open.

The spans are stamped with ``time.time_ns()``, the clock of the
profiler's events, and kept in the port's memory, so they are joined to
the trace by time alone. A reader finds nothing, and returns None, when
the run has no trace, the port has no tracer (a tree older than it), the
tracer dropped spans, or no span lies in the window."""


def window_spans(reading):
    """The port's spans that start and end inside the traced window, in
    order of start, or None."""
    trace = reading.get("trace")
    if trace is None:
        return None
    try:
        from voiceprintrecognition_paddlepaddle_torch.utils import tracing
    except ImportError:
        return None
    if tracing.dropped:
        return None
    lo, hi = trace.window
    spans = [s for s in tracing.spans() if lo <= s.start_ns and s.end_ns <= hi]
    return spans or None


def named(spans, name):
    return [s for s in spans if s.name == name]


def mean_ms(spans):
    return sum(s.end_ns - s.start_ns for s in spans) / len(spans) / 1e6


def dispatching_thread(spans, root):
    """The thread that spent the most time inside spans named ``root``."""
    per = {}
    for s in named(spans, root):
        per[s.thread] = per.get(s.thread, 0) + s.end_ns - s.start_ns
    return max(per, key=per.get) if per else None


def idle_by_span(trace, spans, thread):
    """Every idle gap of the window (``trace.gaps()``) split by the
    innermost span of ``thread`` open at each instant: ``{name: idle
    seconds}``, with ``None`` for the time that thread was in no span.
    The values sum to the window's idle seconds."""
    lo, hi = trace.window
    marks = []
    for k, s in enumerate(spans):
        if s.thread == thread:
            # at one instant ends come before starts; a parent (which
            # sorts before its child) opens first
            marks.append((s.start_ns, 1, k))
            marks.append((s.end_ns, 0, k))
    marks.sort()
    segments, open_, prev = [], [], lo
    for t, starts, k in marks:
        t = min(max(t, lo), hi)
        if t > prev:
            segments.append((prev, t, spans[open_[-1]].name if open_ else None))
            prev = t
        if starts:
            open_.append(k)
        else:
            open_.remove(k)
    if hi > prev:
        segments.append((prev, hi, None))
    out, j = {}, 0
    for g0, g1 in trace.gaps():
        while j < len(segments) and segments[j][1] <= g0:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < g1:
            s0, s1, name = segments[k]
            overlap = min(s1, g1) - max(s0, g0)
            if overlap > 0:
                out[name] = out.get(name, 0.0) + overlap / 1e9
            k += 1
    return out


def idle_share(reading, root, inside):
    """The share of the window, in percent, in which the device was idle
    while the thread dispatching ``root`` spans was innermost in a span
    that ``inside(name)`` accepts."""
    spans = window_spans(reading)
    if spans is None:
        return None
    thread = dispatching_thread(spans, root)
    if thread is None:
        return None
    trace = reading["trace"]
    idle = idle_by_span(trace, spans, thread)
    return 100.0 * sum(v for k, v in idle.items()
                       if k is not None and inside(k)) / trace.window_s
