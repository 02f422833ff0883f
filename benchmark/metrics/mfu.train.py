"""The train step's share of the card's peak: three times the whole
forward of one crop (``forward_flops`` of the reference module the
configuration names, at the crop's frames) for every utterance stepped
in the traced window, over the window's length and the peak of the
configuration's ``train_precision`` (TF32 for CAM++: cuDNN's convs carry
most of the step in TF32)."""

from benchmark import core
from benchmark.work import PEAK_FLOPS


def read(reading):
    trace, c = reading.get("trace"), reading.get("counters", {})
    if trace is None or not c.get("steps"):
        return None
    frames, config = c["frames"], reading["config"]
    forward = core.reference(config).forward_flops(frames, (frames - 1) // 2 + 1)
    flops = 3 * forward * c["steps"] * c["batch"]
    return 100.0 * flops / trace.window_s / PEAK_FLOPS[config["train_precision"]]
