"""Mean host ms of ``Trainer.train_step`` on the stepping thread: the
port's ``vpr.train.step`` spans in the window (featurize, forward,
backward and the optimizer's step dispatched; the device may still be
working when a span ends)."""

from benchmark.metrics._program import dispatching_thread, mean_ms, window_spans


def read(reading):
    spans = window_spans(reading)
    if spans is None:
        return None
    thread = dispatching_thread(spans, "vpr.train.step")
    steps = [s for s in spans if s.name == "vpr.train.step" and s.thread == thread]
    return mean_ms(steps) if steps else None
