"""Shared by the embedding ``mfu`` readers: the whole model's FLOPs over
every clip's valid frames (``forward_flops`` of the reference module the
configuration names) of the batches in the traced window, over the
window's length and the peak of the precision the configuration computes
in (its ``precision``), in percent."""

from benchmark import core
from benchmark.work import PEAK_FLOPS, trunk_rows, valid_frames


def share(reading):
    trace, config = reading.get("trace"), reading["config"]
    if trace is None or not reading.get("work"):
        return None
    flops_of = core.reference(config).forward_flops
    flops = 0
    for lens, padded in reading["work"]:
        for f, r in zip(valid_frames(lens, padded), trunk_rows(lens, padded)):
            flops += flops_of(f, r)
    return 100.0 * flops / trace.window_s / PEAK_FLOPS[config["precision"]]
